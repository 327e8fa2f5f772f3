"""The port's counter-keyed noise (``core/noise.py``, ``ops/noise.py``) held
against ``dfd_tpu.core.noise.CounterNoise`` and ``jax.random``, on the CPU.

The threefry bits and the uniform equal JAX's bit for bit.  eps is held to
4e-6 absolute: the port's plain version computes log1p with PyTorch's libm
where XLA's CPU backend uses its own, an ulp apart now and then, which the
erf_inv polynomial carries into eps.  The
kernel's own check against the plain version runs on the card
(``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per xdist worker)
from dfd_tpu.core.noise import CounterNoise as JaxCounterNoise
from dfd_tpu.fd import combine as jax_combine
from dfd_tpu_torch.core.noise import CounterNoise
from dfd_tpu_torch.fd import combine as port_combine
from dfd_tpu_torch.ops import noise as nz

CPU = "cpu"
TOL_EPS = 4e-6


def _keys(seed, epoch, members):
    """JAX's member keys as the int32 [n, 2] tensor the port's noise takes."""
    base = jax.random.key(seed)
    keys = jax.vmap(lambda i: jax.random.key_data(
        jax.random.fold_in(jax.random.fold_in(base, epoch), i)))(jnp.asarray(members))
    return torch.from_numpy(np.asarray(keys).view(np.int32).copy()), keys


@pytest.mark.parametrize("seed, epoch, members, d", [
    (0, 0, [0], 1), (5, 3, [1, 2, 3], 3), (123, 7, [0, 9], 4097), (2**31 - 1, 2, [4], 5000),
])
def test_bits_and_uniform_equal_jax(seed, epoch, members, d):
    tkeys, jkeys = _keys(seed, epoch, members)
    bits = nz._uniform_bits(tkeys, d)
    want_bits = jax.vmap(lambda k: jax.random.bits(jax.random.wrap_key_data(k), (d,),
                                                   jnp.uint32))(jkeys)
    np.testing.assert_array_equal(bits.numpy().astype(np.uint32), np.asarray(want_bits))
    want_u = jax.vmap(lambda k: jax.random.uniform(jax.random.wrap_key_data(k), (d,),
                                                   jnp.float32, nz.LO, 1.0))(jkeys)
    u = nz.uniform_from_bits(bits)
    np.testing.assert_array_equal(u.numpy().view(np.uint32), np.asarray(want_u).view(np.uint32))


def test_member_keys_equal_jax():
    noise, jnoise = CounterNoise(8, 77, device=CPU), JaxCounterNoise(8, 77)
    got = noise.member_key(12, np.arange(5))
    want = jax.vmap(lambda i: jax.random.key_data(jnoise.member_key(12, i)))(jnp.arange(5))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("antithetic", [False, True])
def test_prepared_keys_are_sliced_for_the_epochs_blocks(antithetic):
    """``prepare`` moves an epoch's keys once and the blocks of that epoch
    slice them; another epoch, or members past the prepared ones, get keys
    of their own; the keys and the noise are the same either way."""
    d, P = 33, 8
    noise = CounterNoise(d, 9, antithetic, device=CPU)
    fresh = CounterNoise(d, 9, antithetic, device=CPU)
    noise.prepare(3, P)
    storage = lambda t: t.untyped_storage().data_ptr()
    prepared = storage(noise._prepared[1])
    for start, count in ((0, P), (1, 4), (4, 4), (5, 3)):
        keys, odd = noise._keys(3, start, count)
        want, want_odd = fresh._keys(3, start, count)
        assert odd == want_odd and torch.equal(keys, want) and storage(keys) == prepared
        ids = range(start, start + count)
        assert torch.equal(noise.generate_block(3, ids), fresh.generate_block(3, ids))
    for epoch, start in ((4, 0), (3, P)):
        keys, _ = noise._keys(epoch, start, 2)
        assert storage(keys) != prepared and torch.equal(keys, fresh._keys(epoch, start, 2)[0])


@pytest.mark.parametrize("seed, epoch, start, count, d, antithetic", [
    (0, 0, 0, 1, 1, False),
    (5, 3, 0, 4, 3, False),
    (11, 1, 2, 3, 4097, False),
    (7, 9, 0, 6, 1, True),
    (7, 9, 1, 4, 3, True),      # a block starting on the odd half of a pair
    (3, 2, 3, 3, 4097, True),
])
def test_generate_block_matches_jax(seed, epoch, start, count, d, antithetic):
    noise = CounterNoise(d, seed, antithetic, device=CPU)
    jnoise = JaxCounterNoise(d, seed, antithetic)
    ids = np.arange(start, start + count)
    got = noise.generate_block(epoch, ids).numpy()
    want = np.asarray(jnoise.generate_block(epoch, jnp.asarray(ids)))
    assert got.shape == (count, d) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_EPS)
    if d > 1000:
        assert np.mean(got == want) > 0.97  # most elements are bit-exact
    np.testing.assert_array_equal(noise.generate(epoch, start).numpy(), got[0])
    if antithetic and count > 1:
        pair = next(i for i in range(count - 1) if (start + i) % 2 == 0)
        np.testing.assert_array_equal(got[pair + 1], -got[pair])


def test_generate_matches_jax_at_a_million_lanes():
    noise, jnoise = CounterNoise(1_000_003, 9, device=CPU), JaxCounterNoise(1_000_003, 9)
    got = noise.generate(4, 17).numpy()
    want = np.asarray(jnoise.generate(4, 17))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_EPS)
    assert abs(float(got.mean())) < 5e-3 and abs(float(got.std()) - 1) < 5e-3


@pytest.mark.parametrize("antithetic", [False, True])
def test_perturb_block_writes_the_fused_rows(antithetic):
    """theta + sigma * eps rounded once (XLA's contraction), theta itself as
    the optional last row, eps beside them only when asked."""
    d, sigma = 1027, 0.05
    noise = CounterNoise(d, 4, antithetic, device=CPU)
    theta = torch.from_numpy(np.random.RandomState(1).randn(d).astype(np.float32))
    pert, eps = noise.perturb_block(theta, sigma, 2, range(1, 5), with_eps=True, theta_row=True)
    assert pert.shape == (5, d) and eps.shape == (4, d)
    assert torch.equal(eps, noise.generate_block(2, range(1, 5)))
    assert torch.equal(pert[4], theta)
    want = (theta.double() + np.float32(sigma) * eps.double()).float()
    assert torch.equal(pert[:4], want)
    jnoise = JaxCounterNoise(d, 4, antithetic)
    jeps = jnoise.generate_block(2, jnp.arange(1, 5))
    jpert = jax.jit(lambda t, e: t[None] + sigma * e)(theta.numpy(), jeps)
    np.testing.assert_allclose(pert[:4].numpy(), np.asarray(jpert), rtol=0, atol=sigma * TOL_EPS
                               + 1e-6)
    pert2, none = noise.perturb_block(theta, sigma, 2, range(1, 5))
    assert none is None and torch.equal(pert2, pert[:4])


def test_fma32_rounds_once():
    """1 + 2^-23 + (2^-24 - 2^-60) lies just below a float32 midpoint; the
    float64 sum lands on it and a second rounding would go up."""
    a = torch.tensor([1 + 2.0**-18], dtype=torch.float32)
    b = torch.tensor([2.0**-24 - 2.0**-42], dtype=torch.float32)
    c = torch.tensor([1 + 2.0**-23], dtype=torch.float32)
    assert nz.fma32(a, b, c).item() == 1 + 2.0**-23
    assert (a.double() * b.double() + c.double()).float().item() == 1 + 2.0**-22
    x = torch.from_numpy(np.random.RandomState(2).randn(3, 1000).astype(np.float32))
    exact = (x[0].double() * x[1].double() + x[2].double()).float()
    assert (nz.fma32(x[0], x[1], x[2]) == exact).float().mean() > 0.999


def test_sample_and_decode():
    noise, jnoise = CounterNoise(64, 3, device=CPU), JaxCounterNoise(64, 3)
    enc, eps = noise.sample(5, 2)
    jenc, jeps = jnoise.sample(5, 2)
    assert enc == jenc == "5,2"
    np.testing.assert_allclose(eps, jeps, rtol=0, atol=TOL_EPS)
    np.testing.assert_array_equal(noise.decode(enc), eps)


@pytest.mark.parametrize("chunk", [2, 4])
def test_chunked_combine_matches_jax(chunk):
    d, P, sigma = 777, 8, 0.1
    noise, jnoise = CounterNoise(d, 6, True, device=CPU), JaxCounterNoise(d, 6, True)
    fitness = np.random.RandomState(3).randn(P).astype(np.float32)
    got = port_combine.combine_gradient_chunked(noise, 4, range(P), torch.from_numpy(fitness),
                                                sigma, chunk)
    want = jax_combine.combine_gradient_chunked(jnoise, 4, jnp.arange(P), fitness, sigma, chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    whole = port_combine.combine_gradient(noise.generate_block(4, range(P)),
                                          torch.from_numpy(fitness), sigma)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="must divide"):
        port_combine.combine_gradient_chunked(noise, 4, range(P), torch.from_numpy(fitness),
                                              sigma, 3)


def test_wrapper_refuses_what_the_card_refuses():
    keys, _ = _keys(1, 1, [0, 1])
    theta = torch.zeros(10)
    with pytest.raises(ValueError, match=r"keys must be a contiguous int32 \[2, 2\]"):
        nz.normal(keys.long(), 2, 10)
    with pytest.raises(ValueError, match=r"keys must be a contiguous int32 \[1, 2\]"):
        nz.normal(keys, 1, 10)
    with pytest.raises(ValueError, match=r"keys must be a contiguous int32"):
        nz.normal(torch.cat([keys, keys], 1)[:, ::2], 2, 10)
    with pytest.raises(ValueError, match="theta must be a contiguous float32"):
        nz.normal(keys, 2, 10, theta=theta.double())
    with pytest.raises(ValueError, match="theta must be a contiguous float32"):
        nz.normal(keys, 2, 10, theta=torch.zeros(20)[::2])
    with pytest.raises(ValueError, match="nothing to write"):
        nz.normal(keys, 2, 10, eps=False)
    with pytest.raises(ValueError, match="odd_first pairs rows"):
        nz.normal(keys, 2, 10, odd_first=True)
    eps, pert = nz.normal(keys[:0], 0, 10, theta=theta, theta_row=True)
    assert eps.shape == (0, 10) and torch.equal(pert, theta[None])
    eps, _ = nz.normal(keys, 2, 0)
    assert eps.shape == (2, 0)
