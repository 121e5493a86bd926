"""Dataset assembly: MNIST / Fashion-MNIST with a synthetic fallback.

The reference trains on the real MNIST/Fashion IDX files
(reference: tests/mnist/main-cpu.cpp:21-27). Real files under ``root`` are
used whenever present. Whatever is missing is synthesized from the seed,
so the training path runs with no download and no external checkout:

* labels: the dataset's published per-class counts, shuffled by ``seed``
  (:func:`synthetic_labels`);
* images: deterministic class prototypes (seeded blobs in 28x28 pixel
  space) plus per-sample noise, conditioned on the label stream.

The result has the exact MNIST shapes and dtypes, is linearly-separable-ish
(so solvers show meaningful loss curves and accuracies), and is
bit-reproducible from the seed.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from lbfgs_ffnn.data.idx import read_idx_images, read_idx_labels_u8

# Published per-class counts (digits 0..9 / Fashion classes 0..9).
MNIST_TRAIN_COUNTS = (5923, 6742, 5958, 6131, 5842, 5421, 5918, 6265, 5851, 5949)
MNIST_TEST_COUNTS = (980, 1135, 1032, 1010, 982, 892, 958, 1028, 974, 1009)
FASHION_TRAIN_COUNTS = (6000,) * 10
FASHION_TEST_COUNTS = (1000,) * 10


@dataclasses.dataclass
class Dataset:
    """Train/test split, batch-major float32 (the reference's UnifiedDataset,
    src/unified_optimization.hpp:54-59, stores the transpose)."""

    train_x: np.ndarray
    train_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray
    synthetic_images: bool = False
    synthetic_labels: bool = False

    @property
    def n_train(self) -> int:
        return self.train_x.shape[0]


def synthetic_images_for_labels(
    labels: np.ndarray,
    *,
    side: int = 28,
    num_classes: int = 10,
    seed: int = 123,
    noise_seed: int = 0,
    noise: float = 0.35,
) -> np.ndarray:
    """Deterministic MNIST-shaped images for a given label stream.

    Each class gets a smooth random prototype in [0,1]^(side*side); each
    sample is prototype + N(0, noise) clipped to [0,1], quantized to uint8
    like real MNIST pixels, then scaled back to [0,1] float32.

    ``seed`` fixes the class prototypes (must match between train and test
    splits of one dataset); ``noise_seed`` varies the per-sample noise.
    """
    rng = np.random.default_rng(seed)
    noise_rng = np.random.default_rng((seed, noise_seed))
    d = side * side
    # Smooth prototypes: low-frequency random fields.
    freqs = rng.normal(size=(num_classes, 8, 8))
    protos = np.zeros((num_classes, side, side), dtype=np.float64)
    yy, xx = np.meshgrid(np.linspace(0, 1, side), np.linspace(0, 1, side), indexing="ij")
    for c in range(num_classes):
        field = np.zeros((side, side))
        for i in range(8):
            for j in range(8):
                field += freqs[c, i, j] * np.cos(np.pi * (i * yy + j * xx))
        field = (field - field.min()) / (field.max() - field.min() + 1e-12)
        protos[c] = field
    protos = protos.reshape(num_classes, d)

    labels = np.asarray(labels, dtype=np.int64)
    imgs = protos[labels] + noise * noise_rng.standard_normal((labels.shape[0], d))
    imgs = np.clip(imgs, 0.0, 1.0)
    imgs_u8 = np.round(imgs * 255.0).astype(np.uint8)
    return imgs_u8.astype(np.float32) / 255.0


def synthetic_labels(
    class_counts: tuple[int, ...], max_items: int = 0, *, seed: int = 123,
    split: int = 0,
) -> np.ndarray:
    """Deterministic uint8 label stream with exactly ``class_counts[c]``
    samples of class ``c``, shuffled by ``(seed, split)``. The first
    ``max_items`` are returned (all when ``max_items <= 0``, like the IDX
    readers)."""
    labels = np.repeat(np.arange(len(class_counts), dtype=np.uint8), class_counts)
    labels = np.random.default_rng((seed, split)).permutation(labels)
    return labels[:max_items] if max_items > 0 else labels


def _load_split(
    root: Path | None,
    images_name: str,
    labels_name: str,
    class_counts: tuple[int, ...],
    max_items: int,
    seed: int,
    split: int,
) -> tuple[np.ndarray, np.ndarray, bool, bool]:
    """(x, y, synthetic_images, synthetic_labels) for one split."""
    labels_path = root / labels_name if root is not None else None
    if labels_path is not None and labels_path.exists():
        labels = read_idx_labels_u8(labels_path, max_items)
        syn_labels = False
    else:
        labels = synthetic_labels(class_counts, max_items, seed=seed, split=split)
        syn_labels = True
    y = np.eye(len(class_counts), dtype=np.float32)[labels]
    images_path = root / images_name if root is not None else None
    if images_path is not None and images_path.exists() and images_path.stat().st_size > 1024:
        return read_idx_images(images_path, max_items), y, False, syn_labels
    x = synthetic_images_for_labels(labels, seed=seed, noise_seed=split)
    return x, y, True, syn_labels


def _load(root, names, counts, sizes, seed) -> Dataset:
    root = Path(root) if root is not None else None
    train_x, train_y, si1, sl1 = _load_split(
        root, names[0], names[1], counts[0], sizes[0], seed, 0)
    test_x, test_y, si2, sl2 = _load_split(
        root, names[2], names[3], counts[1], sizes[1], seed, 1)
    return Dataset(train_x, train_y, test_x, test_y,
                   synthetic_images=si1 or si2, synthetic_labels=sl1 or sl2)


def load_mnist(
    train_size: int = 60000,
    test_size: int = 10000,
    root: Path | str | None = None,
    seed: int = 123,
) -> Dataset:
    """MNIST from the IDX files under ``root``. Absent files (all of them
    when ``root`` is None) are synthesized from ``seed``."""
    return _load(
        root,
        ("train-images.idx3-ubyte", "train-labels.idx1-ubyte",
         "t10k-images.idx3-ubyte", "t10k-labels.idx1-ubyte"),
        (MNIST_TRAIN_COUNTS, MNIST_TEST_COUNTS), (train_size, test_size), seed,
    )


def load_fashion_mnist(
    train_size: int = 60000,
    test_size: int = 10000,
    root: Path | str | None = None,
    seed: int = 456,
) -> Dataset:
    """Fashion-MNIST, same conventions as :func:`load_mnist`."""
    return _load(
        root,
        ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
         "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
        (FASHION_TRAIN_COUNTS, FASHION_TEST_COUNTS), (train_size, test_size), seed,
    )
