"""hpx_tpu_torch.utils.prng against jax.random on the CPU.

Keys, threefry bits, ``fold_in``, ``uniform`` and the ``categorical``
draw are exact: the port repeats threefry-2x32 in int64 arithmetic on
the bit path of ``jax_threefry_partitionable=True``. The Gumbel noise
goes through two ``log`` calls, which XLA and PyTorch round alike on
these inputs; the draw's argmax is compared exactly over many keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpx_tpu.models import transformer as rt
from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.utils import prng

SEEDS = [0, 1, 7, 12345, 2**31 - 1, 2**32 + 5]


def _key(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k) if jnp.issubdtype(
        k.dtype, jax.dtypes.prng_key) else k).astype(np.int64)


def test_jax_runs_the_partitionable_bit_path():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey(seed):
    assert prng.PRNGKey(seed).tolist() == _key(
        jax.random.PRNGKey(seed)).tolist()


@pytest.mark.parametrize("data", [0, 1, 5, 1023, 2**31 + 7, 2**32 - 1])
@pytest.mark.parametrize("seed", [0, 7, 2**32 + 5])
def test_fold_in(seed, data):
    want = _key(jax.random.fold_in(jax.random.PRNGKey(seed), data))
    got = prng.fold_in(prng.PRNGKey(seed), data)
    assert got.tolist() == want.tolist()


def test_fold_in_batched_keys_and_data():
    keys = torch.stack([prng.PRNGKey(s) for s in SEEDS])
    data = torch.arange(len(SEEDS)) * 977
    got = prng.fold_in(keys, data)
    for i, s in enumerate(SEEDS):
        want = _key(jax.random.fold_in(jax.random.PRNGKey(s), int(data[i])))
        assert got[i].tolist() == want.tolist()


@pytest.mark.parametrize("n", [1, 7, 64, 1000])
@pytest.mark.parametrize("seed", [0, 3, 2**32 + 5])
def test_random_bits(seed, n):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), (n,),
                                      jnp.uint32)).astype(np.int64)
    got = prng.random_bits(prng.PRNGKey(seed), n)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 3, 99])
def test_uniform_tiny_to_one(seed):
    tiny = float(jnp.finfo(jnp.float32).tiny)
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (513,),
                                         jnp.float32, tiny, 1.0))
    got = prng.uniform(prng.PRNGKey(seed), 513, tiny, 1.0)
    assert np.array_equal(got.numpy().view(np.uint32),
                          want.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 3])
def test_gumbel(seed):
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (257,)))
    got = prng.gumbel(prng.PRNGKey(seed), 257).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("vocab", [2, 64, 1024])
def test_categorical_draws_equal_over_many_keys(vocab):
    rng = np.random.default_rng(vocab)
    logits = rng.standard_normal((200, vocab)).astype(np.float32) * 2
    keys = [jax.random.fold_in(jax.random.PRNGKey(vocab), i)
            for i in range(200)]
    want = [int(jax.random.categorical(k, jnp.asarray(l)))
            for k, l in zip(keys, logits)]
    pkeys = torch.as_tensor(np.stack([_key(k) for k in keys]))
    got = prng.categorical(pkeys, torch.from_numpy(logits)).tolist()
    assert got == want


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_sample_row_and_pick_row(temperature):
    rng = np.random.default_rng(3)
    for i in range(40):
        row = rng.standard_normal(64).astype(np.float32) * 3
        key = jax.random.PRNGKey(i)
        pos = int(rng.integers(0, 500))
        want_pick = int(rt._pick_row(jnp.asarray(row), key,
                                     jnp.float32(temperature), pos))
        got_pick = int(pt._pick_row(torch.from_numpy(row),
                                    prng.as_key(np.asarray(key)),
                                    temperature, pos))
        assert got_pick == want_pick
        if temperature > 0:
            want = int(rt._sample_row(jnp.asarray(row), temperature, key,
                                      pos, i % 3))
            got = int(pt._sample_row(torch.from_numpy(row), temperature,
                                     prng.as_key(np.asarray(key)), pos,
                                     i % 3))
            assert got == want


def test_as_key_accepts_either_framework_and_checks_shape():
    k = jax.random.PRNGKey(2**32 + 5)
    assert prng.as_key(np.asarray(k)).tolist() == _key(k).tolist()
    assert prng.as_key(prng.PRNGKey(9)).tolist() == prng.PRNGKey(9).tolist()
    with pytest.raises(ValueError, match="shape"):
        prng.as_key([1, 2, 3])
    with pytest.raises(ValueError, match="integers"):
        prng.as_key(np.zeros(2, np.float32))
