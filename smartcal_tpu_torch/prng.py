"""Threefry-2x32 PRNG keys in numpy, bit-compatible with ``jax.random``.

The episode streams of the envs are chains of key splits
(``CalibEnv._next_key``); every draw below a key is a host numpy Generator
seeded from the key words (``cal/observation.host_rng``).  Reproducing
``jax.random.PRNGKey`` and ``jax.random.split`` here, with JAX's default
partitionable threefry (``jax_threefry_partitionable=True`` since JAX
0.5), makes ``CalibEnv(seed=s)`` build the same episodes in both
packages.  A key is a ``(2,)`` uint32 numpy array.
"""

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 hash (20 rounds) of the counter pair (x1, x2) under
    the key (k1, k2); all uint32 numpy arrays or scalars."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` in JAX's default 32-bit mode: the seed
    is taken modulo 2^32 and the high word is 0."""
    return np.asarray([0, int(seed) & 0xFFFFFFFF], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` under partitionable threefry: key i
    is threefry2x32(key, (hi(i), lo(i))) of a 64-bit counter i."""
    key = np.asarray(key, np.uint32)
    counts = np.arange(num, dtype=np.uint64)
    hi = (counts >> np.uint64(32)).astype(np.uint32)
    lo = (counts & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return np.stack([b1, b2], axis=-1)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: threefry2x32(key, (0, data)) of
    the 32-bit ``data``, the fleets' per-(actor, iteration) derivation."""
    key = np.asarray(key, np.uint32)
    b1, b2 = threefry2x32(key[0], key[1], np.uint32(0),
                          np.uint32(int(data) & 0xFFFFFFFF))
    return np.asarray([b1, b2], np.uint32)


def generator_seed(key) -> int:
    """The 63-bit ``torch.Generator`` seed of a key: its two words as one
    integer, high word first, top bit cleared.  A fleet actor seeds its
    generator from its ``fold_in`` key this way."""
    k = np.asarray(key, np.uint32).reshape(-1)
    return ((int(k[0]) << 32) | int(k[1])) & ((1 << 63) - 1)
