"""PyTorch port vs the JAX package: threefry and the RNG contract.

The hash, fold_in, the counter-mode draws, the uniform map and bitrev32 are
integer functions and must agree BIT FOR BIT (the port carries uint32 words
in int64, see raytracinginoneweekend_tpu_torch/ops/threefry.py). The float
maps (polar maps, stratified remaps, Russian roulette) go through sin/cos/
sqrt/pow of two different libms (XLA:CPU's and PyTorch's), so they agree to
atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginoneweekend_tpu.ops import rng as jrng
from raytracinginoneweekend_tpu.ops import threefry as jtf
from raytracinginoneweekend_tpu_torch.ops import rng as prng
from raytracinginoneweekend_tpu_torch.ops import threefry as ptf

SHAPE = (16, 128)


def _u32_planes(seed, n):
    g = np.random.default_rng(seed)
    return [g.integers(0, 2 ** 32, size=SHAPE, dtype=np.uint32)
            for _ in range(n)]


def _t(a):
    """uint32 numpy plane -> the port's int32 bit-pattern tensor."""
    return torch.from_numpy(a.view(np.int32).copy())


def _np_u32(x):
    """the port's u32-in-int64 carrier -> uint32 numpy."""
    return x.numpy().astype(np.uint32)


def _uniform_planes(seed, n):
    g = np.random.default_rng(seed)
    return [g.random(SHAPE, dtype=np.float32) for _ in range(n)]


def test_threefry2x32_bit_exact():
    k0, k1, x0, x1 = _u32_planes(0, 4)
    j0, j1 = jtf.threefry2x32(*(jnp.asarray(a) for a in (k0, k1, x0, x1)))
    p0, p1 = ptf.threefry2x32(_t(k0), _t(k1), _t(x0), _t(x1))
    np.testing.assert_array_equal(_np_u32(p0), np.asarray(j0))
    np.testing.assert_array_equal(_np_u32(p1), np.asarray(j1))


def test_fold_in_words_bit_exact_including_negative_data():
    k0, k1 = _u32_planes(1, 2)
    data = np.random.default_rng(2).integers(-5, 2 ** 31 - 1, size=SHAPE,
                                             dtype=np.int32)
    data[0, :4] = -1  # lanes without a task fold in -1 (0xFFFFFFFF)
    j0, j1 = jtf.fold_in_words(jnp.asarray(k0), jnp.asarray(k1),
                               jnp.asarray(data))
    p0, p1 = ptf.fold_in_words(_t(k0), _t(k1), torch.from_numpy(data))
    np.testing.assert_array_equal(_np_u32(p0), np.asarray(j0))
    np.testing.assert_array_equal(_np_u32(p1), np.asarray(j1))
    # carrier -> int32 bit pattern -> carrier round trip
    np.testing.assert_array_equal(
        ptf.as_i32(p0).numpy().view(np.uint32), np.asarray(j0))


@pytest.mark.parametrize("tag,j", [(0, 0), (1, 2), (2, 3), (52, 1)])
def test_draw_uniform2_bit_exact(tag, j):
    k0, k1 = _u32_planes(3, 2)
    ju0, ju1 = jtf.draw_uniform2(jnp.asarray(k0), jnp.asarray(k1), tag, j)
    pu0, pu1 = ptf.draw_uniform2(_t(k0), _t(k1), tag, j)
    assert pu0.dtype == torch.float32
    np.testing.assert_array_equal(pu0.numpy(), np.asarray(ju0))
    np.testing.assert_array_equal(pu1.numpy(), np.asarray(ju1))
    assert float(pu0.min()) >= 0.0 and float(pu0.max()) < 1.0


def test_uniform_from_bits_and_bitrev32_bit_exact():
    (bits,) = _u32_planes(4, 1)
    bits[0, :3] = (0, 0xFFFFFFFF, 0x80000000)
    np.testing.assert_array_equal(
        ptf.uniform_from_bits(_t(bits)).numpy(),
        np.asarray(jtf.uniform_from_bits(jnp.asarray(bits))))
    np.testing.assert_array_equal(
        _np_u32(prng.bitrev32(_t(bits))),
        np.asarray(jrng.bitrev32(jnp.asarray(bits))))


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 + 5, 2 ** 32 - 1])
def test_key_words_match_jax_random_key(seed):
    want = np.asarray(jax.random.key_data(jax.random.key(np.uint32(seed))))
    assert ptf.key_words(seed) == (int(want[0]), int(want[1]))


def test_key_words_rejects_out_of_range():
    with pytest.raises(ValueError):
        ptf.key_words(-1)
    with pytest.raises(ValueError):
        ptf.key_words(2 ** 32)


def test_polar_maps_close():
    # atol 1e-6: sin/cos/sqrt of XLA:CPU vs PyTorch differ by an ulp or two.
    u0, u1 = _uniform_planes(5, 2)
    for jf, pf in ((jrng.unit_from_uv, prng.unit_from_uv),
                   (jrng.disk_from_uv, prng.disk_from_uv)):
        want = jf(jnp.asarray(u0), jnp.asarray(u1))
        got = pf(torch.from_numpy(u0), torch.from_numpy(u1))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                       rtol=0)


@pytest.mark.parametrize("spp", [1, 7, 100])
def test_stratified_remaps_close(spp):
    # atol 1e-6: a float32 division and an add; in practice bit-equal.
    ju, rot_u, rot_v = _uniform_planes(6, 3)
    sid = np.random.default_rng(7).integers(0, spp, size=SHAPE,
                                            dtype=np.int32)
    want = jrng.stratify_uv(jnp.asarray(ju), jnp.asarray(rot_v),
                            jnp.asarray(sid), spp)
    got = prng.stratify_uv(torch.from_numpy(ju), torch.from_numpy(rot_v),
                           torch.from_numpy(sid), spp)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
    want = jrng.stratify_lens_uv(jnp.asarray(ju), jnp.asarray(rot_u),
                                 jnp.asarray(rot_v), jnp.asarray(sid), spp)
    got = prng.stratify_lens_uv(torch.from_numpy(ju),
                                torch.from_numpy(rot_u),
                                torch.from_numpy(rot_v),
                                torch.from_numpy(sid), spp)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)


def test_stratified_needs_spp():
    z = torch.zeros(SHAPE)
    with pytest.raises(ValueError):
        prng.stratify_uv(z, z, z.to(torch.int32), 0)
    with pytest.raises(ValueError):
        prng.stratify_lens_uv(z, z, z, z.to(torch.int32), 0)


@pytest.mark.parametrize("rr_scale,rr_qmin,rr_start",
                         [(4.0, 0.05, 3), (1.0, 0.2, 1)])
def test_rr_terminate_update_close(rr_scale, rr_qmin, rr_start):
    k0, k1 = _u32_planes(8, 2)
    ax, ay, az = (a * 0.6 for a in _uniform_planes(9, 3))
    g = np.random.default_rng(10)
    depth = g.integers(0, 8, size=SHAPE, dtype=np.int32)
    keep = g.random(SHAPE) < 0.8
    kw = dict(rr_start=rr_start, rr_qmin=rr_qmin, rr_scale=rr_scale)
    jx, jy, jz, jkeep = jrng.rr_terminate_update(
        jnp.asarray(k0), jnp.asarray(k1), jnp.asarray(depth),
        jnp.asarray(ax), jnp.asarray(ay), jnp.asarray(az),
        jnp.asarray(keep), **kw)
    px, py, pz, pkeep = prng.rr_terminate_update(
        _t(k0), _t(k1), torch.from_numpy(depth), torch.from_numpy(ax),
        torch.from_numpy(ay), torch.from_numpy(az), torch.from_numpy(keep),
        **kw)
    # The survival draw is bit-exact, q is a product and a clip: masks may
    # differ only where |u_rr - q| < 1e-6.
    tag = jnp.uint32(2) + jnp.asarray(depth).astype(jnp.uint32)
    u_rr = np.asarray(jtf.draw_uniform2(jnp.asarray(k0), jnp.asarray(k1),
                                        tag, 2)[0])
    q = np.clip(rr_scale * np.maximum(ax, np.maximum(ay, az)), rr_qmin, 1.0)
    edge = np.abs(u_rr - q) < 1e-6
    same = pkeep.numpy() == np.asarray(jkeep)
    assert (same | edge).all()
    for got, want in ((px, jx), (py, jy), (pz, jz)):
        np.testing.assert_allclose(got.numpy()[same], np.asarray(want)[same],
                                   atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# Key-array API (the tiled engine). The JAX package vmaps scalar functions
# over a key array; the port's are batched over (N,) key-word tensors. Key
# words and raw uniforms: BIT-EQUAL. Vectors through sin/cos/sqrt/pow of
# two libms: rtol 1e-5 / atol 1e-6.
# ---------------------------------------------------------------------------

N_KEYS, KEY_SEED, KEY_SPP = 500, 11, 12


def _pid_sid_flat():
    g = np.random.default_rng(3)
    return (g.integers(0, 5000, size=N_KEYS, dtype=np.int32),
            g.integers(0, KEY_SPP, size=N_KEYS, dtype=np.int32))


def _ray_keys():
    pid, sid = _pid_sid_flat()
    base = jax.random.key(KEY_SEED)
    jkeys = jax.vmap(lambda p, s: jrng.ray_key(base, p, s))(
        jnp.asarray(pid), jnp.asarray(sid))
    pkeys = prng.ray_key(ptf.key_words(KEY_SEED), torch.from_numpy(pid),
                         torch.from_numpy(sid))
    return jkeys, pkeys


def test_ray_key_words_bit_exact():
    jkeys, pkeys = _ray_keys()
    j0, j1 = jtf.key_words(jkeys)
    np.testing.assert_array_equal(_np_u32(pkeys[0]), np.asarray(j0))
    np.testing.assert_array_equal(_np_u32(pkeys[1]), np.asarray(j1))


def test_step_key_fold_chain_bit_exact():
    """fit's keys: fold_in(base, i), then fold_in(., 0) / fold_in(., 1)."""
    from raytracinginoneweekend_tpu_torch.optim.inverse import step_keys

    base = jax.random.key(7)
    for i in (0, 1, 17, 1000):
        kstep = jax.random.fold_in(base, i)
        for which, got in zip((0, 1), step_keys(ptf.key_words(7), i)):
            want = jtf.key_words(jax.random.fold_in(kstep, which))
            assert tuple(int(w) for w in got) == tuple(
                int(w) for w in want)


def test_jitter_uv_bit_exact():
    jkeys, pkeys = _ray_keys()
    want = np.asarray(jax.vmap(jrng.jitter_uv)(jkeys))  # (N, 2)
    got = prng.jitter_uv(pkeys)
    for k in range(2):
        np.testing.assert_array_equal(got[k].numpy(), want[:, k])


@pytest.mark.parametrize("fn", ["lens_disk", "lens_sphere"])
def test_lens_samples_close(fn):
    jkeys, pkeys = _ray_keys()
    want = jax.vmap(getattr(jrng, fn))(jkeys)
    got = getattr(prng, fn)(pkeys)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("sample", ["unit", "ball"])
@pytest.mark.parametrize("bounce", [0, 3])
def test_key_array_bounce_draws(bounce, sample):
    jkeys, pkeys = _ray_keys()
    wvec, wu = jax.vmap(lambda k: jrng.bounce_draws(k, bounce, sample))(
        jkeys)
    gvec, gu = prng.bounce_draws(pkeys, bounce, sample)
    np.testing.assert_array_equal(gu.numpy(), np.asarray(wu))
    np.testing.assert_allclose(gvec.numpy(), np.asarray(wvec), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("sample", ["unit", "ball"])
def test_key_array_strat0_scatter(sample):
    jkeys, pkeys = _ray_keys()
    pid, sid = _pid_sid_flat()
    base = jax.random.key(KEY_SEED)
    want = jax.vmap(lambda k, p, s: jrng.strat0_scatter(
        k, p, s, base, KEY_SPP, sample))(jkeys, jnp.asarray(pid),
                                         jnp.asarray(sid))
    got = prng.strat0_scatter(pkeys, torch.from_numpy(pid),
                              torch.from_numpy(sid),
                              ptf.key_words(KEY_SEED), KEY_SPP, sample)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_rr_terminate_update_qcap_and_stop_grad():
    """rr_qcap caps the survival probability; stop_grad holds q constant
    under autograd (the values are the same either way)."""
    k0, k1 = _u32_planes(21, 2)
    ax, ay, az = (torch.from_numpy(a).requires_grad_(True)
                  for a in _uniform_planes(22, 3))
    keep = torch.ones(SHAPE, dtype=torch.bool)
    kw = dict(rr_start=1, rr_qmin=0.05, rr_scale=4.0)
    outs = {}
    for stop in (True, False):
        o = prng.rr_terminate_update(_t(k0), _t(k1), 3, ax, ay, az, keep,
                                     rr_qcap=0.5, stop_grad=stop, **kw)
        outs[stop] = o
        g, = torch.autograd.grad(o[0].sum(), ax)
        if stop:  # d(ax/q)/d(ax) = 1/q >= 1/qcap on survivors
            surv = o[3]
            assert bool((g[surv] >= 2.0 - 1e-6).all())
            assert bool((g[~surv] == 1.0).all())
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy())
    jo = jrng.rr_terminate_update(
        jnp.asarray(k0), jnp.asarray(k1), jnp.int32(3),
        *(jnp.asarray(a.detach().numpy()) for a in (ax, ay, az)),
        jnp.asarray(keep.numpy()), rr_qcap=0.5, **kw)
    for g_, w in zip(outs[True], jo):
        np.testing.assert_allclose(g_.detach().numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# jax.random's own layouts (the gradient surrogates draw through them)
# ---------------------------------------------------------------------------

def _key_pair(seed, tag):
    """The same key in both packages: fold_in(key(seed), tag)."""
    jkey = jax.random.fold_in(jax.random.key(seed), tag)
    return jkey, ptf.fold_in_words(*ptf.key_words(seed), tag)


@pytest.mark.parametrize("shape", [(1,), (5, 1), (7, 3, 2), (4097,)])
def test_jax_random_bits_and_uniform_bit_exact(shape):
    """jax.random.bits / uniform under jax_threefry_partitionable: the bits
    equal, so the uniforms equal (the same mantissa map)."""
    jkey, pkey = _key_pair(3, 101)
    np.testing.assert_array_equal(
        _np_u32(ptf.random_bits(pkey, shape, "cpu")),
        np.asarray(jax.random.bits(jkey, shape)))
    got = ptf.uniform(pkey, shape, "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax.random.uniform(jkey, shape)))


def test_jax_random_uniform_with_bounds():
    """minval/maxval as jax.random.uniform applies them: bit-exact on the
    gumbel sampler's [tiny, 1) (the only bounds the surrogates use besides
    the default); on an arbitrary interval within one ulp, as XLA:CPU
    contracts f * span + lo into a fused multiply-add."""
    jkey, pkey = _key_pair(4, 7)
    np.testing.assert_array_equal(
        ptf.uniform(pkey, (64, 9), "cpu", minval=ptf.F32_TINY).numpy(),
        np.asarray(jax.random.uniform(jkey, (64, 9),
                                      minval=ptf.F32_TINY)))
    got = ptf.uniform(pkey, (64, 9), "cpu", minval=-2.5, maxval=0.75)
    want = np.asarray(jax.random.uniform(jkey, (64, 9), minval=-2.5,
                                         maxval=0.75))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=np.spacing(np.float32(2.5)))
    assert float(got.min()) >= -2.5 and float(got.max()) < 0.75


def test_vmapped_fold_in_bit_exact():
    """jax.vmap(jax.random.fold_in, (None, 0))(key, arange(n)): the
    per-sample keys of the surrogates' probe paths."""
    jkey, pkey = _key_pair(5, 102)
    want = np.asarray(jax.random.key_data(jax.vmap(
        jax.random.fold_in, (None, 0))(jkey, jnp.arange(300,
                                                        dtype=jnp.int32))))
    k0, k1 = ptf.fold_in_words(*pkey, torch.arange(300))
    np.testing.assert_array_equal(_np_u32(k0), want[:, 0])
    np.testing.assert_array_equal(_np_u32(k1), want[:, 1])


def test_gumbel_close_and_categorical_picks_agree():
    """gumbel = -log(-log(u)) with the same u; the logs are PyTorch's and
    XLA's, so the noise agrees to a few ulps (atol 2e-6) and a categorical
    pick can differ only on a near tie. The secondary surrogate's draw
    shape (P, K) over S categories with -inf logits: the share of picks
    that differ is stated, at most 1e-3 (measured: 0 of 40000)."""
    jkey, pkey = _key_pair(6, 105)
    np.testing.assert_allclose(
        ptf.gumbel(pkey, (2000,), "cpu").numpy(),
        np.asarray(jax.random.gumbel(jkey, (2000,))), rtol=0, atol=2e-6)
    g = np.random.default_rng(0)
    q = g.random((10000, 9)).astype(np.float32)
    q[g.random(q.shape) < 0.3] = 0.0
    q[:5] = 0.0  # rows without a candidate: flattened to uniform logits
    logits = np.where(q > 0, np.log(np.maximum(q, 1e-30)), -np.inf)
    logits = np.where(q.sum(1, keepdims=True) > 0, logits, 0.0)
    logits = logits.astype(np.float32)
    want = np.asarray(jax.random.categorical(
        jkey, jnp.asarray(logits)[:, None, :], axis=-1, shape=(10000, 4)))
    got = ptf.categorical(pkey, torch.from_numpy(logits)[:, None, :],
                          (10000, 4)).numpy()
    assert got.shape == want.shape == (10000, 4)
    assert (got != want).mean() <= 1e-3, (got != want).sum()
    picked = np.take_along_axis(q, got, axis=1)
    assert (picked[5:] > 0).all()  # never a -inf category


def test_plain_square_roots_round_to_nearest_as_xla():
    """torch.sqrt of a float32 tensor on the CPU is not rounded to
    nearest (some inputs come out an ulp off); XLA's square root is. The plain versions take ops/math3.sqrt_rn. Held on the disk map's
    radius: at u0 = 0 the disk point is (sqrt(u1), 0) in both packages
    (cos 0 = 1, sin 0 = 0 exactly), so it is the square root alone."""
    u1 = np.random.default_rng(7).random(3000, dtype=np.float32)
    u0 = np.zeros_like(u1)
    want = np.asarray(jax.jit(jrng.disk_from_uv)(u0, u1)[0])
    old = torch.sqrt(torch.from_numpy(u1)).numpy()
    assert (old != want).sum() >= 5  # the class: torch.sqrt is an ulp off
    got = prng.disk_from_uv(torch.from_numpy(u0), torch.from_numpy(u1))[0]
    np.testing.assert_array_equal(got.numpy(), want)
