"""The port's constant-current, time-to-first-spike and burst codes and
``lif_init_state`` against the JAX package's, bit for bit on the same
NumPy inputs: the three codes are deterministic (burst coding takes a key
and draws nothing from it).  The inputs include x = 0 (TTFS never spikes),
x = 1, and the half-way points of ``round(x * max_burst)``, which both
packages round half to even.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jencoding
from repro.core import lif as jlif
from repro_torch.core import encoding, lif


def _inputs(max_burst=4):
    """(3, 12) intensities in [0, 1]: random, the ends, and every
    half-way point k + 0.5 of x * max_burst."""
    rng = np.random.default_rng(0)
    halves = (np.arange(max_burst) + 0.5) / max_burst
    x = np.concatenate([[0.0, 1.0], halves, [0.0, 1.0],
                        rng.random(32 - max_burst)]).astype(np.float32)
    return x.reshape(3, 12)


def _equal(t, j):
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("num_steps", [1, 5, 8])
def test_constant_current(num_steps):
    x = _inputs()
    t = encoding.constant_current_encode(torch.from_numpy(x), num_steps)
    _equal(t, jencoding.constant_current_encode(jnp.asarray(x), num_steps))
    assert t.shape == (num_steps,) + x.shape


@pytest.mark.parametrize("num_steps", [1, 5, 8])
def test_ttfs(num_steps):
    x = _inputs()
    t = encoding.ttfs_encode(torch.from_numpy(x), num_steps)
    _equal(t, jax.jit(jencoding.ttfs_encode, static_argnums=1)(
        jnp.asarray(x), num_steps))
    counts = t.sum(0).numpy()
    assert (counts[x == 0] == 0).all() and (counts[x > 0] == 1).all()
    if num_steps > 1:
        assert (t[0].numpy()[x == 1] == 1).all()


@pytest.mark.parametrize("max_burst", [2, 4, 7])
@pytest.mark.parametrize("num_steps", [3, 8])
def test_burst(num_steps, max_burst):
    x = _inputs(max_burst)
    t = encoding.burst_encode(torch.Generator().manual_seed(0),
                              torch.from_numpy(x), num_steps, max_burst)
    _equal(t, jencoding.burst_encode(jax.random.key(0), jnp.asarray(x),
                                     num_steps, max_burst))
    # leading spikes, round(x * max_burst) of them, halves to even (at
    # max_burst 2 and 4 the half-way points are exact: 0.5 -> 0, 1.5 -> 2)
    want = np.minimum(np.round(x * np.float32(max_burst)), num_steps)
    np.testing.assert_array_equal(t.sum(0).numpy(), want)
    assert (np.diff(t.numpy(), axis=0) <= 0).all()
    if max_burst == 4:
        assert list(want.ravel()[2:6]) == [min(k, num_steps)
                                           for k in (0, 2, 2, 4)]


def test_burst_draws_nothing():
    g = torch.Generator().manual_seed(3)
    before = g.get_state().clone()
    encoding.burst_encode(g, torch.from_numpy(_inputs()), 4)
    assert torch.equal(g.get_state(), before)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lif_init_state(dtype):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tu, ts = lif.lif_init_state((3, 5), tdt, device="cpu")
    ju, js = jlif.lif_init_state((3, 5), jdt)
    for t, j in ((tu, ju), (ts, js)):
        assert t.dtype == tdt and tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))
    with pytest.raises(TypeError, match="device"):
        lif.lif_init_state((2,))
