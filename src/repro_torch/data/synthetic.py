"""Synthetic datasets standing in for the paper's MNIST and Spambase, and
for LLM token streams.

A numpy copy of ``repro/data/synthetic.py``: the same seed gives the same
bytes, so the port and the JAX package train on identical data.  A gaussian mixture with matched dimensionality (784
features and 10 classes, or 54 binary features and 2 classes), inputs
normalized to [-1, 1] as in the paper.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SyntheticClassification(NamedTuple):
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int

    @property
    def dim(self) -> int:
        return self.x_train.shape[1]


def _make_protos(rng, dim: int, num_classes: int, sep: float):
    """Class prototypes on a sphere of radius sep*sqrt(dim)."""
    protos = rng.normal(size=(num_classes, dim)).astype(np.float32)
    protos *= sep * np.sqrt(dim) / np.linalg.norm(protos, axis=1, keepdims=True)
    return protos


def _sample(rng, protos, n: int, binary: bool):
    num_classes, dim = protos.shape
    y = rng.integers(0, num_classes, size=n)
    x = protos[y] + rng.normal(scale=1.0, size=(n, dim)).astype(np.float32)
    if binary:
        x = (x > 0).astype(np.float32)
    else:
        x = np.tanh(x)  # normalize to [-1, 1] as the paper does
    return x.astype(np.float32), y.astype(np.int32)


def make_mnist_like(
    seed: int = 0, n_train: int = 10_000, n_test: int = 2_000, dim: int = 784,
    num_classes: int = 10, sep: float = 0.5,
) -> SyntheticClassification:
    rng = np.random.default_rng(seed)
    protos = _make_protos(rng, dim, num_classes, sep)
    xtr, ytr = _sample(rng, protos, n_train, False)
    xte, yte = _sample(rng, protos, n_test, False)
    return SyntheticClassification(xtr, ytr, xte, yte, num_classes)


def make_spambase_like(
    seed: int = 0, n_train: int = 3_680, n_test: int = 921, dim: int = 54,
) -> SyntheticClassification:
    rng = np.random.default_rng(seed)
    protos = _make_protos(rng, dim, 2, 0.5)
    xtr, ytr = _sample(rng, protos, n_train, True)
    xte, yte = _sample(rng, protos, n_test, True)
    return SyntheticClassification(xtr, ytr, xte, yte, 2)


class TokenStream(NamedTuple):
    """Synthetic LM corpus: a bigram-markov source so next-token prediction is
    learnable (per-token optimum is the markov conditional)."""

    tokens: np.ndarray  # (n,) int32

    def batches(self, rng, batch: int, seq: int, n_batches: int):
        n = len(self.tokens) - seq - 1
        for _ in range(n_batches):
            idx = rng.integers(0, n, size=batch)
            tok = np.stack([self.tokens[i : i + seq] for i in idx])
            lab = np.stack([self.tokens[i + 1 : i + seq + 1] for i in idx])
            yield {"tokens": tok.astype(np.int32), "labels": lab.astype(np.int32)}


def make_token_stream(seed: int = 0, vocab: int = 256, n: int = 200_000) -> TokenStream:
    rng = np.random.default_rng(seed)
    # sparse random bigram transition table
    trans = rng.dirichlet(np.full(16, 0.5), size=vocab)  # (V, 16)
    nxt = rng.integers(0, vocab, size=(vocab, 16))
    toks = np.empty(n, np.int32)
    toks[0] = rng.integers(0, vocab)
    for i in range(1, n):
        row = toks[i - 1]
        toks[i] = nxt[row, rng.choice(16, p=trans[row])]
    return TokenStream(toks)
