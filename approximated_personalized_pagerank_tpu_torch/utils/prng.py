"""Counter-based threefry-2x32 random numbers, bit for bit those of
``jax.random`` (jax 0.9, ``jax_threefry_partitionable=True``).

The walks of MCCompletePathV2 (ops/walk.py) draw every random number from
keys derived from one root key; reproducing JAX's stream exactly is what
lets a walk of the port be held bitwise against the JAX package's.  What is
reproduced:

* :func:`prng_key` -- ``jax.random.PRNGKey(seed)`` with 64-bit mode off:
  the key ``(0, seed mod 2**32)``;
* :func:`fold_in` -- ``threefry_2x32(key, (0, data))``;
* :func:`split` -- the fold-like split: key ``i`` is the hash of the
  counter pair ``(hi(i), lo(i))``;
* :func:`uniform` -- float32 in ``[0, 1)``: 32 random bits per element,
  ``hi ^ lo`` of the hash of the element's flat index, then
  ``(bits >> 9) | 0x3F800000`` read as a float, minus 1.

A key is a pair of ints in ``[0, 2**32)``, or a ``[2]`` int64 tensor.
There is no global state: every stream is a function of its key.  Words are
held in int64 and masked to 32 bits after every operation that can carry,
so no operation depends on unsigned or overflowing int32 arithmetic.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

MASK32 = 0xFFFFFFFF
# The Threefry-2x32 rotation schedule and key-schedule parity constant
# (Salmon et al., SC'11; jax/_src/prng.py).
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA

Word = Union[int, torch.Tensor]
Key = Union[Tuple[int, int], torch.Tensor]


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1: Word, k2: Word, x1: Word, x2: Word) -> Tuple[Word, Word]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x1, x2)``
    under the key ``(k1, k2)``.  Arguments are ints or int64 tensors holding
    32-bit words, broadcast against each other."""
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def _words(key: Key) -> Tuple[Word, Word]:
    if isinstance(key, torch.Tensor):
        if key.shape != (2,):
            raise ValueError(f"a key tensor must have shape [2], got {tuple(key.shape)}")
        key = key.to(torch.int64)
        return key[0], key[1]
    k1, k2 = (int(k) for k in key)
    for k in (k1, k2):
        if not 0 <= k <= MASK32:
            raise ValueError(f"key words must lie in [0, 2**32), got {k}")
    return k1, k2


def _like(key: Key, w1: Word, w2: Word) -> Key:
    if isinstance(key, torch.Tensor):
        return torch.stack([w1, w2])
    return int(w1), int(w2)


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: ``(0, seed mod
    2**32)``."""
    return 0, int(seed) & MASK32


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for ``0 <= data < 2**32``; the
    result has the type of ``key``."""
    data = int(data)
    if not 0 <= data <= MASK32:
        raise ValueError(f"fold_in data must lie in [0, 2**32), got {data}")
    k1, k2 = _words(key)
    return _like(key, *threefry2x32(k1, k2, 0, data))


def split(key: Key, num: int = 2) -> list:
    """``jax.random.split(key, num)`` as a list of ``num`` keys of the type
    of ``key``."""
    k1, k2 = _words(key)
    return [_like(key, *threefry2x32(k1, k2, i >> 32, i & MASK32)) for i in range(num)]


def _bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits -> float32 in [0, 1): 23 mantissa bits under the
    exponent of 1.0, minus 1."""
    f_bits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return f_bits.view(torch.float32) - 1.0


def uniform_many(
    keys: Sequence[Key], shape: Sequence[int], device,
    rows: Tuple[int, int] | None = None,
) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` for each key, stacked:
    ``float32[len(keys), *shape]`` on ``device``.  One hash over all keys
    at once (the keys broadcast against the shape's counters).

    ``rows=(offset, total)`` draws a window of a larger array: the result
    is rows ``offset .. offset + shape[1]`` along axis 1 of
    ``jax.random.uniform(key, (shape[0], total, *shape[2:]))`` (the counters
    are partitionable, so a slice of the draw costs only its own bits)."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    words = [_words(k) for k in keys]
    k1 = torch.stack([torch.as_tensor(w[0], dtype=torch.int64) for w in words])
    k2 = torch.stack([torch.as_tensor(w[1], dtype=torch.int64) for w in words])
    k1 = k1.to(device)[:, None]
    k2 = k2.to(device)[:, None]
    idx = torch.arange(n, dtype=torch.int64, device=device)
    if rows is not None:
        offset, total = rows
        inner = n // max(shape[0] * shape[1], 1)  # elements past axis 1
        lead, rest = idx // (shape[1] * inner), idx % (shape[1] * inner)
        idx = (lead * total + offset) * inner + rest
    idx = idx[None, :]
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK32)
    return _bits_to_unit_float(b1 ^ b2).reshape((len(words),) + shape)


def uniform(key: Key, shape: Sequence[int], device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1) on ``device``."""
    return uniform_many([key], shape, device)[0]
