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
