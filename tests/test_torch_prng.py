"""The port's threefry (utils/prng.py) against ``jax.random``: keys, fold-in,
split and uniform floats, bit for bit.  The walks of MCCompletePathV2 draw
every random number through these functions, so bitwise equality here is
what makes the port's walks the JAX package's."""

import jax
import numpy as np
import pytest
import torch

from approximated_personalized_pagerank_tpu_torch.utils import prng

SEEDS = [0, 1, 2**31 - 1]
DATA = [0, 7, 9344, 2**31 + 5, 2**32 - 1]


def _key(k):
    return tuple(int(x) for x in np.asarray(k))


def test_threefry_is_partitionable():
    # the stream the port reproduces; the default of jax 0.9
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS + [-1, 2**32 + 3])
def test_prng_key(seed):
    assert prng.prng_key(seed) == _key(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", DATA)
def test_fold_in(seed, data):
    want = _key(jax.random.fold_in(jax.random.PRNGKey(seed), data))
    key = prng.prng_key(seed)
    assert prng.fold_in(key, data) == want
    # a [2] int64 tensor key gives a tensor key of the same words
    got = prng.fold_in(torch.tensor(key, dtype=torch.int64), data)
    assert tuple(got.tolist()) == want


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3])
def test_split(seed, num):
    key = prng.prng_key(seed)
    want = [_key(k) for k in jax.random.split(jax.random.PRNGKey(seed), num)]
    assert prng.split(key, num) == want
    got = prng.split(torch.tensor(key), num)
    assert [tuple(k.tolist()) for k in got] == want


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(32, 512, 16), (3, 7, 5), (1,)])
def test_uniform_bits(seed, shape):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 512)
    want = np.asarray(jax.random.uniform(jkey, shape))
    got = prng.uniform(_key(jkey), shape, "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_uniform_many_is_each_key_alone():
    """The walk draws both of a macro step's streams in one call."""
    k_choice, k_cont = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(1), 3))
    both = prng.uniform_many([_key(k_choice), _key(k_cont)], (4, 6, 5), "cpu")
    for got, k in zip(both, (k_choice, k_cont)):
        want = np.asarray(jax.random.uniform(k, (4, 6, 5)))
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert float(both.min()) >= 0.0 and float(both.max()) < 1.0


def test_bad_keys_and_data_raise():
    with pytest.raises(ValueError, match="fold_in data"):
        prng.fold_in((0, 1), -3)
    with pytest.raises(ValueError, match="fold_in data"):
        prng.fold_in((0, 1), 2**32)
    with pytest.raises(ValueError, match="key words"):
        prng.split((0, 2**32))
    with pytest.raises(ValueError, match="shape"):
        prng.fold_in(torch.zeros(3, dtype=torch.int64), 0)


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
def test_uniform_bits_equal_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    key = prng.fold_in(prng.prng_key(1), 512)
    cpu = prng.uniform_many(prng.split(key), (32, 512, 16), "cpu")
    gpu = prng.uniform_many(prng.split(key), (32, 512, 16), "cuda").cpu()
    assert torch.equal(cpu.view(torch.int32), gpu.view(torch.int32))
