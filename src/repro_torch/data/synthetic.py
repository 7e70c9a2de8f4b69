"""Synthetic federated tasks (the offline stand-ins for MNIST/FMNIST/CIFAR).

A numpy copy of ``repro/data/synthetic.py``: the same generators with the
same seeds give bit-identical arrays.

Three task families with *controllable difficulty*, so the paper's
grid-search-on-one-task → transfer-to-others protocol is reproducible:

  * ``gaussian_mixture`` — k-class Gaussian blobs through a random rotation,
    difficulty set by class margin and within-class scale ("hard" ≈ CIFAR,
    "easy" ≈ MNIST in the paper's narrative).
  * ``two_layer_teacher`` — labels from a random 2-layer teacher net; the
    optimum has genuinely non-uniform local smoothness.
  * ``image_blobs`` — (H,W,1) images: class-dependent frequency patterns +
    noise, for the CNN model.
  * ``lm_tokens`` — Markov-chain token sequences, the text-domain analog.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class TaskData:
    name: str
    x: np.ndarray          # (N, ...) float32
    y: np.ndarray          # (N,) int32
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int


def gaussian_mixture(name: str, *, dim=32, num_classes=10, n_train=50_000,
                     n_test=5_000, margin=3.0, scale=1.0, seed=0,
                     nonlinear=False) -> TaskData:
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(num_classes, dim)).astype(np.float32)
    means *= margin / np.linalg.norm(means, axis=1, keepdims=True)
    rot = np.linalg.qr(rng.normal(size=(dim, dim)))[0].astype(np.float32)

    def sample(n):
        y = rng.integers(0, num_classes, n).astype(np.int32)
        x = means[y] + scale * rng.normal(size=(n, dim)).astype(np.float32)
        x = x @ rot
        if nonlinear:
            x = np.tanh(x) + 0.1 * x ** 2
        return x.astype(np.float32), y

    x, y = sample(n_train)
    xt, yt = sample(n_test)
    return TaskData(name, x, y, xt, yt, num_classes)


def two_layer_teacher(name: str, *, dim=32, num_classes=10, hidden=64,
                      n_train=50_000, n_test=5_000, seed=0,
                      temp=1.0) -> TaskData:
    rng = np.random.default_rng(seed)
    w1 = rng.normal(size=(dim, hidden)).astype(np.float32) / np.sqrt(dim)
    w2 = rng.normal(size=(hidden, num_classes)).astype(np.float32) \
        / np.sqrt(hidden)

    def sample(n):
        x = rng.normal(size=(n, dim)).astype(np.float32)
        logits = np.maximum(x @ w1, 0) @ w2 / temp
        # sample labels from the teacher's softmax (label noise built in)
        z = logits - logits.max(1, keepdims=True)
        p = np.exp(z) / np.exp(z).sum(1, keepdims=True)
        y = np.array([rng.choice(num_classes, p=pi) for pi in p],
                     dtype=np.int32)
        return x, y

    x, y = sample(n_train)
    xt, yt = sample(n_test)
    return TaskData(name, x, y, xt, yt, num_classes)


def image_blobs(name: str, *, size=16, num_classes=10, n_train=50_000,
                n_test=5_000, noise=0.5, seed=0) -> TaskData:
    """Class-dependent 2-D sinusoid patterns + Gaussian noise, (H,W,1)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    patterns = np.stack([
        np.sin(2 * np.pi * ((c % 4 + 1) * xx + (c // 4 + 1) * yy
                            + c / num_classes))
        for c in range(num_classes)]).astype(np.float32)

    def sample(n):
        y = rng.integers(0, num_classes, n).astype(np.int32)
        x = patterns[y] + noise * rng.normal(
            size=(n, size, size)).astype(np.float32)
        return x[..., None].astype(np.float32), y

    x, y = sample(n_train)
    xt, yt = sample(n_test)
    return TaskData(name, x, y, xt, yt, num_classes)


def lm_tokens(name: str, *, vocab=256, n_train=4_000, n_test=400, seq=64,
              seed=0) -> TaskData:
    """Markov-chain token sequences; "x" = tokens (N, seq), "y" the
    sample's class (labels are next tokens). A sample's class picks its
    transition matrix, so the Dirichlet partitioner still applies."""
    rng = np.random.default_rng(seed)
    num_classes = 10
    # block-structured transition matrices, one per class
    mats = []
    for c in range(num_classes):
        m = rng.dirichlet(np.full(vocab, 0.05), size=vocab)
        mats.append(m.astype(np.float32))

    def sample(n):
        y = rng.integers(0, num_classes, n).astype(np.int32)
        x = np.zeros((n, seq), np.int32)
        for i in range(n):
            m = mats[y[i]]
            t = rng.integers(0, vocab)
            for j in range(seq):
                x[i, j] = t
                t = rng.choice(vocab, p=m[t])
        return x, y

    x, y = sample(n_train)
    xt, yt = sample(n_test)
    return TaskData(name, x, y, xt, yt, num_classes)


# Named task registry used by benchmarks (difficulty ordering mirrors the
# paper's MNIST < FMNIST < CIFAR-10 < CIFAR-100 ladder).
def get_task(task_id: str, seed: int = 0) -> TaskData:
    if task_id == "easy":        # ~MNIST: well-separated blobs
        return gaussian_mixture("easy", margin=4.0, scale=0.6, seed=seed)
    if task_id == "medium":      # ~FMNIST
        return gaussian_mixture("medium", margin=2.5, scale=1.0,
                                nonlinear=True, seed=seed + 1)
    if task_id == "hard":        # ~CIFAR: teacher net, high label noise
        return two_layer_teacher("hard", temp=0.7, seed=seed + 2)
    if task_id == "image":       # CNN task
        return image_blobs("image", noise=0.8, seed=seed + 3)
    if task_id == "lm":          # text-domain analog
        return lm_tokens("lm", seed=seed + 4)
    raise KeyError(task_id)
