"""Keras dataset loaders (reference python/flexflow/keras/datasets/).

The reference downloads MNIST/CIFAR from the network. This environment has
zero egress, so ``load_data`` first looks for a local npz cache
(``$FF_KERAS_DATA`` or ``~/.keras/datasets/``) and otherwise generates a
*deterministic synthetic* stand-in with the same shapes/dtypes: each class is
a fixed random template plus noise, so models genuinely learn (accuracy well
above chance) and convergence tests remain meaningful.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

Arrays = Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]


def _cache_path(fname: str) -> Optional[str]:
    for base in (os.environ.get("FF_KERAS_DATA"),
                 os.path.expanduser("~/.keras/datasets")):
        if base:
            p = os.path.join(base, fname)
            if os.path.exists(p):
                return p
    return None


def _synthetic_images(shape, num_classes: int, n_train: int, n_test: int,
                      seed: int) -> Arrays:
    rng = np.random.RandomState(seed)
    templates = rng.rand(num_classes, *shape) * 255.0

    def make(n, seed2):
        r = np.random.RandomState(seed2)
        y = r.randint(0, num_classes, size=(n,))
        noise = r.randn(n, *shape) * 32.0
        x = np.clip(templates[y] + noise, 0, 255).astype(np.uint8)
        return x, y

    xtr, ytr = make(n_train, seed + 1)
    xte, yte = make(n_test, seed + 2)
    return (xtr, ytr), (xte, yte)


class mnist:
    @staticmethod
    def load_data(path: str = "mnist.npz", n_train: int = 6000,
                  n_test: int = 1000) -> Arrays:
        cached = _cache_path(path)
        if cached:
            with np.load(cached, allow_pickle=True) as f:
                return (f["x_train"], f["y_train"]), (f["x_test"], f["y_test"])
        return _synthetic_images((28, 28), 10, n_train, n_test, seed=1234)


class cifar10:
    @staticmethod
    def load_data(n_train: int = 5000, n_test: int = 1000) -> Arrays:
        cached = _cache_path("cifar-10.npz")
        if cached:
            with np.load(cached, allow_pickle=True) as f:
                return (f["x_train"], f["y_train"]), (f["x_test"], f["y_test"])
        (xtr, ytr), (xte, yte) = _synthetic_images(
            (3, 32, 32), 10, n_train, n_test, seed=4321)
        return (xtr, ytr.reshape(-1, 1)), (xte, yte.reshape(-1, 1))


class cifar100:
    @staticmethod
    def load_data(label_mode: str = "fine", n_train: int = 5000,
                  n_test: int = 1000) -> Arrays:
        # fine/coarse labels come from different caches — a fine-label npz
        # must not satisfy a coarse-mode request
        cache_name = ("cifar-100.npz" if label_mode == "fine"
                      else "cifar-100-coarse.npz")
        cached = _cache_path(cache_name)
        if cached:
            with np.load(cached, allow_pickle=True) as f:
                return (f["x_train"], f["y_train"]), (f["x_test"], f["y_test"])
        num = 100 if label_mode == "fine" else 20
        (xtr, ytr), (xte, yte) = _synthetic_images(
            (3, 32, 32), num, n_train, n_test, seed=2222)
        return (xtr, ytr.reshape(-1, 1)), (xte, yte.reshape(-1, 1))


class reuters:
    """Synthetic stand-in for the Reuters newswire topic dataset."""

    @staticmethod
    def load_data(num_words: int = 10000, maxlen: int = 200,
                  n_train: int = 2000, n_test: int = 500,
                  num_classes: int = 46):
        rng = np.random.RandomState(46)
        # class-dependent unigram distributions so the task is learnable
        logits = rng.randn(num_classes, num_words) * 2.0

        def make(n, seed):
            r = np.random.RandomState(seed)
            y = r.randint(0, num_classes, size=(n,))
            xs = []
            for lab in y:
                p = np.exp(logits[lab] - logits[lab].max())
                p /= p.sum()
                length = r.randint(maxlen // 2, maxlen)
                xs.append(r.choice(num_words, size=length, p=p).tolist())
            return np.asarray(xs, dtype=object), y
        xtr, ytr = make(n_train, 7)
        xte, yte = make(n_test, 8)
        return (xtr, ytr), (xte, yte)
