"""The port's Threefry-2x32 (``repro_torch/core/threefry.py``) against
jax's own bits: the key of a seed, the split chain the micro-simulator
walks, and uniform draws at the simulator's (12, 64) and at ragged
shapes, under jax's default ``jax_threefry_partitionable=True``."""
import jax
import numpy as np
import pytest
import torch

from repro_torch.core import threefry

SEEDS = (0, 1, 7, 12345, 2 ** 31 - 1)


def _words(key):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(key))
                 .reshape(-1))


def test_partitionable_threefry_is_jax_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("key,ctr,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_known_answers(key, ctr, want):
    """Random123's known-answer vectors for threefry2x32 with 20 rounds,
    on Python ints and on int64 tensors."""
    assert threefry.threefry2x32(*key, *ctr) == want
    got = threefry.threefry2x32(*(torch.tensor([v]) for v in key + ctr))
    assert tuple(int(g) for g in got) == want


@pytest.mark.parametrize("seed", SEEDS + (2 ** 32 + 5, -3))
def test_prng_key_matches_jax(seed):
    assert threefry.prng_key(seed) == _words(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_chain_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    want = []
    for _ in range(100):
        key, sub = jax.random.split(key)
        want.append(_words(sub))
    last, subs = threefry.split_chain(threefry.prng_key(seed), 100)
    assert subs == want and last == _words(key)
    nxt, sub = threefry.split(threefry.prng_key(seed))
    k0, k1 = jax.random.split(jax.random.PRNGKey(seed))
    assert (nxt, sub) == (_words(k0), _words(k1))


@pytest.mark.parametrize("shape", [(12, 64), (3, 5, 7), (7,), (1, 1)])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax(seed, shape):
    _, subs = threefry.split_chain(threefry.prng_key(seed), 3)
    got = threefry.uniform(subs, shape)
    key = jax.random.PRNGKey(seed)
    for i in range(3):
        key, sub = jax.random.split(key)
        want = np.asarray(jax.random.uniform(sub, shape))
        assert got[i].dtype == torch.float32
        assert np.array_equal(got[i].numpy().view(np.uint32),
                              want.view(np.uint32)), (seed, shape, i)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.bits(key, (4, 33), dtype=np.uint32))
    got = threefry.random_bits([threefry.prng_key(seed)], (4, 33))[0]
    assert np.array_equal(got.numpy().astype(np.uint32), want)
