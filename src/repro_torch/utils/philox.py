"""Philox-4x32-10 in plain torch integer ops: the keyed random streams of the
fused round engines.

Counterpart of the ``jax.random`` keys of ``repro/fed/engine.py``
(``client_keys_traced``, ``_BATCH_STREAM``, ``attack_key``).  A CUDA graph
replays its kernels with the arguments they were captured with, so a
generator seeded on the host each round would repeat its draws in every
replay; a counter-based generator reads its key and counter from device
tensors instead.  Every draw is a pure function of

    (seed, stream, offset = round * K + original client id, element index)

and so the same on the CPU and on the card, bit for bit, and the same
whatever row a client occupies: compacting the client axis changes the
layout of the draws, never their values.

The generator is Philox-4x32 with 10 rounds (Salmon et al., SC'11, as the
Random123 library defines it): key ``(seed mod 2^32, seed >> 32)``, counter
``(call, offset, stream, 0)``; call ``j`` yields the four words ``4 j .. 4 j +
3`` of a row.  Words are int64 tensors holding values in ``[0, 2^32)``; each
32 x 32-bit product is put together from two 32 x 16-bit products, so no
int64 operation overflows.  The same functions run on Python ints (the tests'
reference) and on tensors of any shape that broadcast.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57      # Philox-4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85      # Weyl key increments
ROUNDS = 10


def _mulhilo(a, m: int):
    """``(hi, lo)``: the 32-bit halves of ``a * m`` for a word ``a`` (int or
    tensor) and a 32-bit constant ``m``."""
    if isinstance(a, int):
        p = a * m
        return p >> 32, p & M32
    p_lo = a * (m & 0xFFFF)                 # < 2^48
    p_hi = a * (m >> 16)                    # < 2^48
    s = p_lo + ((p_hi & 0xFFFF) << 16)      # < 2^49: the low 48 bits of a * m, plus a carry
    return (p_hi >> 16) + (s >> 32), s & M32


def _key_schedule(k: int | torch.Tensor, w: int) -> list:
    """The key word of each round: ``k + r w mod 2^32`` for r < ROUNDS."""
    if isinstance(k, int):
        return [(k + r * w) & M32 for r in range(ROUNDS)]
    ks = (k + w * torch.arange(ROUNDS, dtype=torch.int64, device=k.device)) & M32
    return list(ks.unbind(0))


def philox4x32(ctr, key):
    """Philox-4x32-10 of the counter words ``ctr = (c0, c1, c2, c3)`` under
    ``key = (k0, k1)``; each word an int or an int64 tensor in ``[0, 2^32)``,
    tensors broadcasting against each other.  Returns the four output words."""
    c0, c1, c2, c3 = ctr
    k0s, k1s = _key_schedule(key[0], _W0), _key_schedule(key[1], _W1)
    for r in range(ROUNDS):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0s[r], lo1, hi0 ^ c3 ^ k1s[r], lo0
    return c0, c1, c2, c3


def keyed_words(seed, stream: int, offsets: torch.Tensor, n: int) -> torch.Tensor:
    """``(R, n)`` int64 words in ``[0, 2^32)``: row r holds words ``0 .. n-1``
    of the stream ``(seed, stream, offsets[r])``.  ``seed`` is a non-negative
    int or a 0-d int64 tensor on ``offsets``' device; ``offsets`` an ``(R,)``
    int64 tensor of values below 2^32."""
    calls = -(-int(n) // 4)
    call = torch.arange(calls, dtype=torch.int64, device=offsets.device)[None, :]
    words = philox4x32((call, offsets[:, None], int(stream), 0),
                       (seed & M32, (seed >> 32) & M32))
    words = torch.stack(torch.broadcast_tensors(*words), dim=-1)   # (R, calls, 4)
    return words.reshape(offsets.shape[0], 4 * calls)[:, :n]


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    """Words in ``[0, 2^32)`` -> int32 tensors of the same bits."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def keyed_bits(seed, stream: int, offsets: torch.Tensor, n: int) -> torch.Tensor:
    """``(R, n)`` bool fair coins: element i is bit ``i mod 32`` (least
    significant first) of word ``i // 32`` of the row's stream."""
    words = _as_int32(keyed_words(seed, stream, offsets, -(-int(n) // 32)))
    bit = _as_int32(1 << torch.arange(32, dtype=torch.int64, device=offsets.device))
    bits = torch.bitwise_and(words[..., None], bit) != 0          # (R, words, 32)
    return bits.reshape(offsets.shape[0], -1)[:, :n]


def keyed_randint(seed, stream: int, offsets: torch.Tensor, n: int,
                  high: torch.Tensor) -> torch.Tensor:
    """``(R, n)`` int64 draws in ``[0, high[r])``, ``high`` an ``(R,)`` integer
    tensor of values in ``[1, 2^31)``: ``word * high >> 32``
    (multiply-shift; its bias is below ``high / 2^32``)."""
    words = keyed_words(seed, stream, offsets, n)
    return (words * high.to(torch.int64)[:, None]) >> 32


_TWO_PI = 2.0 * math.pi
_INV_2_24 = 2.0 ** -24


def keyed_normal(seed, stream: int, offsets: torch.Tensor, n: int) -> torch.Tensor:
    """``(R, n)`` float32 standard normals by Box-Muller on word pairs: the
    top 24 bits of the pair give ``u1`` in ``(0, 1]`` and ``u2`` in ``[0, 1)``,
    and ``sqrt(-2 ln u1) (cos, sin)(2 pi u2)`` fill elements ``2 i, 2 i + 1``.
    The words are the same on every device; ``log``, ``cos`` and ``sin`` may
    round their last bit differently on the CPU and on the card."""
    pairs = -(-int(n) // 2)
    words = keyed_words(seed, stream, offsets, 2 * pairs).reshape(offsets.shape[0], pairs, 2)
    u1 = ((words[..., 0] >> 8) + 1).to(torch.float32) * _INV_2_24
    u2 = (words[..., 1] >> 8).to(torch.float32) * _INV_2_24
    radius = torch.sqrt(-2.0 * torch.log(u1))
    theta = _TWO_PI * u2
    z = torch.stack((radius * torch.cos(theta), radius * torch.sin(theta)), dim=-1)
    return z.reshape(offsets.shape[0], 2 * pairs)[:, :n]
