"""Synthetic datasets with the exact shapes of the paper's benchmarks
(Table 1).

A numpy copy of the regression, digits and token-stream parts of
`repro/data/synthetic.py` (the port does not import `repro`).  The
regression generator is seeded with crc32 of the dataset name and the
digits and token generators with the seed, so the arrays are identical
to the reference's.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Tuple

import numpy as np

# (n_samples, n_features) of the real datasets used in the paper (Table 1)
REGRESSION_SPECS: Dict[str, Tuple[int, int]] = {
    "diabetes": (442, 10),
    "boston": (506, 13),
    "red_wine": (1599, 11),
    "white_wine": (4898, 11),
}


@dataclasses.dataclass
class RegressionData:
    name: str
    x_train: np.ndarray      # (N, n_tr, d) worker-sharded
    y_train: np.ndarray      # (N, n_tr)
    x_val: np.ndarray        # (N, n_val, d)
    y_val: np.ndarray
    x_test: np.ndarray       # (n_test, d) global
    y_test: np.ndarray


def _ground_truth(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Mildly non-linear teacher: linear + tanh interaction."""
    lin = x @ w[: x.shape[1]]
    inter = np.tanh(x @ np.roll(w[: x.shape[1]], 1)) * 0.5
    return lin + inter


def make_regression(name: str, n_workers: int, seed: int = 0,
                    val_frac: float = 0.2,
                    test_frac: float = 0.2) -> RegressionData:
    n, d = REGRESSION_SPECS[name]
    # crc32, not hash(): Python string hashing is salted per process
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 65536)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d,)).astype(np.float32) / np.sqrt(d)
    y = _ground_truth(x, w) + 0.1 * rng.normal(size=(n,))
    y = ((y - y.mean()) / (y.std() + 1e-8)).astype(np.float32)

    n_test = int(n * test_frac)
    x_test, y_test = x[:n_test], y[:n_test]
    x_rem, y_rem = x[n_test:], y[n_test:]
    n_val = int(len(x_rem) * val_frac)

    # equal worker shards (truncate the remainder for a rectangular array)
    def shard(a, n_per):
        per = (len(a) // n_workers)
        a = a[: per * n_workers].reshape(n_workers, per, *a.shape[1:])
        return a[:, :n_per]

    n_tr_per = (len(x_rem) - n_val) // n_workers
    n_val_per = max(1, n_val // n_workers)
    xv, yv = x_rem[:n_val], y_rem[:n_val]
    xt, yt = x_rem[n_val:], y_rem[n_val:]
    return RegressionData(
        name=name,
        x_train=shard(xt, n_tr_per), y_train=shard(yt, n_tr_per),
        x_val=shard(xv, n_val_per), y_val=shard(yv, n_val_per),
        x_test=x_test, y_test=y_test)


@dataclasses.dataclass
class DigitsData:
    """Two-domain digit recognition stand-in (MNIST-like / SVHN-like)."""
    x_pretrain: np.ndarray   # (N, n_pt, 32, 32, 1)
    y_pretrain: np.ndarray   # (N, n_pt)
    x_finetune: np.ndarray   # (N, n_ft, 32, 32, 1)
    y_finetune: np.ndarray
    x_test: np.ndarray       # (n_test, 32, 32, 1) finetune-domain test
    y_test: np.ndarray


def _render_digit(rng, label: int, domain: str) -> np.ndarray:
    """Procedural 32x32 'digit': a class-specific frequency pattern.

    The two domains differ by contrast, background clutter and blur, so
    pretraining on one transfers imperfectly to the other: the setting
    the reweighting network of Eq. 32 exploits."""
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32.0
    f1, f2 = 1 + label % 5, 1 + label // 5
    img = (np.sin(2 * np.pi * f1 * xx + label)
           * np.cos(2 * np.pi * f2 * yy - label))
    if domain == "svhn":
        img = 0.6 * img + 0.8 * rng.normal(size=img.shape)  # clutter
        img = img + 0.3 * np.sin(2 * np.pi * 3 * (xx + yy))  # color cast
    else:
        img = img + 0.15 * rng.normal(size=img.shape)
    img = np.clip(img, -2, 2) / 2.0
    return img[..., None].astype(np.float32)


def make_digits(n_workers: int, n_pretrain_per: int = 64,
                n_finetune_per: int = 32, n_test: int = 256,
                pretrain_domain: str = "svhn",
                seed: int = 0) -> DigitsData:
    rng = np.random.default_rng(seed)
    ft_domain = "mnist" if pretrain_domain == "svhn" else "svhn"

    def batch(n, domain):
        ys = rng.integers(0, 10, size=n)
        xs = np.stack([_render_digit(rng, int(y), domain) for y in ys])
        return xs.astype(np.float32), ys.astype(np.int32)

    xpt, ypt = zip(*[batch(n_pretrain_per, pretrain_domain)
                     for _ in range(n_workers)])
    xft, yft = zip(*[batch(n_finetune_per, ft_domain)
                     for _ in range(n_workers)])
    x_test, y_test = batch(n_test, ft_domain)
    return DigitsData(
        x_pretrain=np.stack(xpt), y_pretrain=np.stack(ypt),
        x_finetune=np.stack(xft), y_finetune=np.stack(yft),
        x_test=x_test, y_test=y_test)


def make_token_stream(vocab_size: int, batch: int, seq_len: int,
                      seed: int = 0, zipf_a: float = 1.2) -> np.ndarray:
    """Zipfian token ids for LM serving smoke runs (the reference's
    generator, so the prompts are identical in both packages)."""
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(zipf_a, size=(batch, seq_len)).astype(np.int64)
    # overflow ranks wrap (mod) rather than clip: clipping would pile the
    # heavy zipf tail onto vocab_size-1 and make it the most frequent id
    return ((ranks - 1) % vocab_size).astype(np.int32)
