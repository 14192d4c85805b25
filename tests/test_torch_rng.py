"""gphocs_tpu_torch.rng_fast against gphocs_tpu.rng_fast: the u32 bits and
the f32/f64 uniforms bitwise, the derived draws at f64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gphocs_tpu import rng as JR
from gphocs_tpu import rng_fast as JF
from gphocs_tpu_torch import rng as TR
from gphocs_tpu_torch import rng_fast as TF
from gphocs_tpu_torch.state import from_numpy, to_numpy

RNG = np.random.default_rng(20260817)
KEYS = RNG.integers(0, 2 ** 32, size=64, dtype=np.uint64).astype(np.uint32)
# counters near 0, mid-range and just below the 2^32 wrap
CTRS = [0, 1, 12345, 2 ** 31 + 7, 2 ** 32 - 3]


def _states(ctr):
    j = JF.FastRngState(key=jnp.asarray(KEYS), ctr=jnp.uint32(ctr))
    return j, from_numpy(j, TF.FastRngState)


def test_fmix32_bitwise():
    z = RNG.integers(0, 2 ** 32, size=4096, dtype=np.uint64).astype(
        np.uint32)
    want = np.asarray(JF._fmix32(jnp.asarray(z)))
    got = TF.fmix32(torch.as_tensor(z.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("ctr", CTRS)
def test_uniform_bits_and_units(ctr):
    j, t = _states(ctr)
    for off in (1, 2, 3, 4):
        c = j.ctr + jnp.uint32(off)
        bits = np.asarray(JF._fmix32(j.key ^ JF._fmix32(c * JF._GOLDEN)))
        got_bits = TF.raw_bits(t.key, t.ctr + off)
        np.testing.assert_array_equal(got_bits.numpy(),
                                      bits.astype(np.int64))
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.float64, torch.float64)):
            want = np.asarray(JF._bits_to_unit(jnp.asarray(bits), jdt))
            got = TF.bits_to_unit(got_bits, tdt).numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            assert np.all((got > 0) & (got < 1))


@pytest.mark.parametrize("ctr", CTRS)
def test_draws_match_at_f64(ctr):
    j, t = _states(ctr)
    f64 = torch.float64
    u_j, j1 = JF.rndu(j, None)
    u_t, t1 = TF.rndu(t, f64)
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
    assert int(t1.ctr) == int(j1.ctr)

    z_j, j2 = JF.rnd2normal8(j, None)
    z_t, t2 = TF.rnd2normal8(t, f64)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-13,
                               atol=1e-15)
    assert int(t2.ctr) == int(j2.ctr)

    e_j, _ = JF.rndexp(j, None, 2.5)
    e_t, _ = TF.rndexp(t, 2.5, f64)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-13)

    for n in (1, 3, 7):
        b_j, bj = JF.batch_u(j, n)
        b_t, bt = TF.batch_u(t, n, f64)
        np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
        n_j, nj = JF.batch_2normal8(j, n)
        n_t, nt = TF.batch_2normal8(t, n, f64)
        np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), rtol=1e-13,
                                   atol=1e-15)
        assert int(bt.ctr) == int(bj.ctr) and int(nt.ctr) == int(nj.ctr)


def test_general_stream_draws():
    j = JF.FastRngState(key=jnp.asarray(KEYS[:1]), ctr=jnp.uint32(99))
    t = from_numpy(j, TF.FastRngState)
    u_j, j1 = JR.general_draw_u(j)
    u_t, t1 = TR.general_draw_u(t, torch.float64)
    assert float(u_t) == float(u_j) and int(t1.ctr) == int(j1.ctr)
    z_j, j2 = JR.general_draw_2normal8(j1)
    z_t, t2 = TR.general_draw_2normal8(t1, torch.float64)
    assert abs(float(z_t) - float(z_j)) < 1e-13
    assert int(t2.ctr) == int(j2.ctr)


@pytest.mark.parametrize("num_slots, seed", [
    (1, 0), (1, 111 + 0x5F3759DF),      # the general stream
    (7, 17), (8, 17),                   # odd and even lane counts
    (1000, 5), (1000, 2 ** 31 + 5), (33, 2 ** 32 - 1),  # seeds above 2^31
    (5, 2 ** 40 + 3),                   # a seed that fills the high key word
])
def test_init_fast_keys_equal_jax(num_slots, seed):
    """init_fast's keys are gphocs_tpu's for the same seed, bit for bit:
    the port's numpy Threefry-2x32 against jax.random.bits (with the
    default threefry2x32 generator in its partitionable layout)."""
    want = JF.init_fast(num_slots, seed)
    got = TF.init_fast(num_slots, seed)
    np.testing.assert_array_equal(got.key.numpy(),
                                  np.asarray(want.key).astype(np.int64))
    assert int(got.ctr) == int(want.ctr) == 0


def test_init_fast_lane_mix_and_roundtrip():
    """init_fast applies gphocs_tpu's lane mix to the Threefry bits; keys
    are distinct and reproducible."""
    k1 = TF.init_fast(1000, 5)
    k2 = TF.init_fast(1000, 5)
    assert torch.equal(k1.key, k2.key) and int(k1.ctr) == 0
    assert len(set(k1.key.tolist())) == 1000
    assert int(k1.key.min()) >= 0 and int(k1.key.max()) < 2 ** 32
    bits = TF.threefry_bits(5, 1000)
    lane = jnp.arange(1000, dtype=jnp.uint32)
    want = JF._fmix32(jnp.asarray(bits) ^ JF._fmix32(lane * JF._GOLDEN))
    np.testing.assert_array_equal(k1.key.numpy(),
                                  np.asarray(want).astype(np.int64))
    back = to_numpy(k1)
    assert np.array_equal(back.key, k1.key.numpy())


# ---- the Wichmann-Hill streams of the conformance mode (no JAX) ----------
# The reference C implementation's values (src/utils.c, gcc -O2), seed
# 12345, 3 loci + 1 general slot, every slot seeded alike: copied from
# tests/test_rng.py.
GOLD_RNDU_SLOT0 = [
    0.0042688455914678958, 0.62853436425211839, 0.95951417036121711,
    0.066568566791829653, 0.33884242226486094, 0.25929171797179151,
    0.30696066853124648, 0.27638592311996035, 0.27231839174055494,
    0.92301977935130708,
]
GOLD_RND2NORMAL8_SLOT1 = [
    0.66878961090114375, -0.62978615503667335, -0.98304464283311499,
    -0.96972107693339271, 0.557807077441971, -1.0561921282874003,
    -0.95513209233305907, 0.50244312769355037,
]
GOLD_RNDNORMAL_SLOT2 = [
    -0.82205829204275882, -0.94807421769542499, -0.18954793512492538,
    0.12070680375315508, 1.8794910910790084,
]


def _lane(k, i):
    m = torch.zeros(k, dtype=torch.bool)
    m[i] = True
    return m


def test_legacy_rndu_equals_c_bitwise():
    """rndu adds the three IEEE quotients as C does: C's values exactly
    (17 digits round-trip a double)."""
    st = TR.init_legacy(4, 12345)
    out = []
    for _ in range(10):
        u, st = TR.rndu(st, _lane(4, 0))
        out.append(float(u[0]))
    np.testing.assert_array_equal(out, GOLD_RNDU_SLOT0)
    # the general stream, seeded alike, repeats slot 0
    g = TR.init_legacy(1, 12345)
    for want in GOLD_RNDU_SLOT0[:5]:
        u, g = TR.general_draw_u(g, torch.float64)
        assert float(u) == want


@pytest.mark.parametrize("draw, lane, gold", [
    ("rnd2normal8", 1, GOLD_RND2NORMAL8_SLOT1),
    ("rndnormal", 2, GOLD_RNDNORMAL_SLOT2),
])
def test_legacy_normals_equal_c(draw, lane, gold):
    """The polar normal and the mixture kernel within 5e-15 of C's (torch's
    log may differ from glibc's by an ulp)."""
    st = TR.init_legacy(4, 12345)
    out = []
    for _ in gold:
        z, st = getattr(TR, draw)(st, _lane(4, lane))
        out.append(float(z[lane]))
    np.testing.assert_allclose(out, gold, rtol=0, atol=5e-15)


def test_legacy_masked_lanes_do_not_advance():
    """Lanes outside the mask keep their state, through rndu and through
    the normals' rejection loop; a general draw that is not active takes
    nothing."""
    st = TR.init_legacy(4, 12345)
    for _ in range(3):
        _, st = TR.rndu(st, _lane(4, 1))
        _, st = TR.rnd2normal8(st, _lane(4, 2))
    u, st = TR.rndu(st, _lane(4, 0))
    assert float(u[0]) == GOLD_RNDU_SLOT0[0]
    assert int(st.x[3]) == 11 and int(st.y[3]) == 23
    g = TR.init_legacy(1, 12345)
    _, g2 = TR.general_draw_2normal8(g, torch.float64, torch.tensor(False))
    assert all(torch.equal(a, b) for a, b in zip(g, g2))
    _, g3 = TR.general_draw_u(g, torch.float64, False)
    assert all(torch.equal(a, b) for a, b in zip(g, g3))


def test_legacy_wraparound_equals_uint32():
    """AS183 without the negative correction: x = 177 steps to 2^32 - 2
    (unsigned wraparound, not -2), and the stream goes on as the host's
    exact uint32 twin (rng_host.HostRng) does, bit for bit."""
    from gphocs_tpu_torch.rng_host import HostRng

    host = HostRng(3, 0)
    host.x[:] = [177, 354, 30000]
    host.y[:] = [176, 23, 29999]
    host.z[:] = [178, 170, 30322]
    st = TR.from_arrays(*host.state_arrays())
    _, st1 = TR.rndu(st, torch.ones(3, dtype=torch.bool))
    assert int(st1.x[0]) == 2 ** 32 - 2
    st = TR.from_arrays(*host.state_arrays())
    for _ in range(50):
        u, st = TR.rndu(st, torch.ones(3, dtype=torch.bool))
        want = [host.rndu(i) for i in range(3)]
        np.testing.assert_array_equal(u.numpy(), want)
    for f, a in zip("xyz", host.state_arrays()):
        np.testing.assert_array_equal(getattr(st, f).numpy(), a, err_msg=f)
    e, st = TR.rndexp(st, torch.ones(3, dtype=torch.bool), 2.5)
    np.testing.assert_allclose(e.numpy(), [host.rndexp(i, 2.5)
                                           for i in range(3)], rtol=1e-15)
