"""Data layer tests: IDX round-trip (native C++ + numpy fallback), dataset
assembly with the synthetic-image fallback."""

import numpy as np
import pytest

from lbfgs_ffnn.data.idx import (
    read_idx_images,
    read_idx_labels_onehot,
    read_idx_labels_u8,
    write_idx_u8,
)
from lbfgs_ffnn.data.datasets import (
    FASHION_TEST_COUNTS,
    FASHION_TRAIN_COUNTS,
    MNIST_TEST_COUNTS,
    MNIST_TRAIN_COUNTS,
    load_fashion_mnist,
    load_mnist,
    synthetic_images_for_labels,
    synthetic_labels,
)
from lbfgs_ffnn.runtime import get_lib


def test_native_runtime_builds():
    """The native C++ runtime must be available in this environment (g++ is
    baked in); the numpy fallback exists for degraded environments only."""
    assert get_lib() is not None


def test_idx_images_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, size=(7, 5, 4), dtype=np.uint8)
    p = tmp_path / "imgs.idx3-ubyte"
    write_idx_u8(p, imgs)
    loaded = read_idx_images(p)
    assert loaded.shape == (7, 20)
    np.testing.assert_allclose(loaded, imgs.reshape(7, 20).astype(np.float32) / 255.0)
    # max_items truncation
    assert read_idx_images(p, max_items=3).shape == (3, 20)


def test_idx_labels_roundtrip(tmp_path):
    labels = np.array([0, 3, 9, 1, 1], dtype=np.uint8)
    p = tmp_path / "labels.idx1-ubyte"
    write_idx_u8(p, labels)
    oh = read_idx_labels_onehot(p, num_classes=10)
    assert oh.shape == (5, 10)
    np.testing.assert_array_equal(np.argmax(oh, axis=1), labels)
    np.testing.assert_array_equal(oh.sum(axis=1), np.ones(5, np.float32))
    np.testing.assert_array_equal(read_idx_labels_u8(p), labels)


@pytest.mark.parametrize("counts", [MNIST_TRAIN_COUNTS, MNIST_TEST_COUNTS,
                                    FASHION_TRAIN_COUNTS, FASHION_TEST_COUNTS])
def test_synthetic_label_stream(counts):
    """Without label files the stream is the published per-class counts,
    shuffled deterministically by the seed; a prefix is a prefix of it."""
    a = synthetic_labels(counts, seed=5)
    np.testing.assert_array_equal(a, synthetic_labels(counts, seed=5))
    assert a.dtype == np.uint8 and a.shape == (sum(counts),)
    np.testing.assert_array_equal(np.bincount(a, minlength=10), counts)
    assert not np.array_equal(a, synthetic_labels(counts, seed=6))
    assert not np.array_equal(a, synthetic_labels(counts, seed=5, split=1)[:len(a)])
    np.testing.assert_array_equal(synthetic_labels(counts, 100, seed=5), a[:100])


def test_synthetic_images_deterministic_and_class_structured():
    labels = np.array([0, 0, 1, 1, 2] * 10)
    a = synthetic_images_for_labels(labels, seed=7)
    b = synthetic_images_for_labels(labels, seed=7)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (50, 784)
    assert a.min() >= 0.0 and a.max() <= 1.0
    # same-class samples are closer than cross-class on average
    d_same = np.linalg.norm(a[0] - a[1])
    d_cross = np.linalg.norm(a[0] - a[2])
    assert d_same < d_cross


def test_load_mnist_small():
    ds = load_mnist(train_size=256, test_size=128)
    assert ds.train_x.shape == (256, 784)
    assert ds.train_y.shape == (256, 10)
    assert ds.test_x.shape == (128, 784)
    assert ds.train_x.dtype == np.float32 and ds.train_y.dtype == np.float32
    assert ds.synthetic_images and ds.synthetic_labels
    # one-hot of the seeded stream, reproducible from the seed
    np.testing.assert_array_equal(
        np.argmax(ds.train_y, axis=1), synthetic_labels(MNIST_TRAIN_COUNTS, 256, seed=123)
    )
    np.testing.assert_array_equal(ds.train_y.sum(axis=1), np.ones(256, np.float32))
    np.testing.assert_array_equal(load_mnist(train_size=256, test_size=128).train_x,
                                  ds.train_x)


def test_load_mnist_full_size_class_counts():
    ds = load_mnist(train_size=60000, test_size=10000)
    assert ds.train_x.shape == (60000, 784) and ds.test_x.shape == (10000, 784)
    np.testing.assert_array_equal(ds.train_y.sum(axis=0), MNIST_TRAIN_COUNTS)
    np.testing.assert_array_equal(ds.test_y.sum(axis=0), MNIST_TEST_COUNTS)


def test_real_idx_files_are_used_when_present(tmp_path):
    """IDX files under ``root`` win over the synthetic stream, per file."""
    labels = np.array([3, 1, 4, 1, 5, 9, 2, 6], dtype=np.uint8)
    write_idx_u8(tmp_path / "train-labels.idx1-ubyte", labels)
    ds = load_mnist(train_size=8, test_size=4, root=tmp_path)
    np.testing.assert_array_equal(np.argmax(ds.train_y, axis=1), labels)
    assert ds.synthetic_images and ds.synthetic_labels  # test split synthesized
    assert ds.test_y.shape == (4, 10)


def test_load_fashion_small():
    ds = load_fashion_mnist(train_size=64, test_size=32)
    assert ds.train_x.shape == (64, 784)
    assert ds.test_y.shape == (32, 10)
    np.testing.assert_array_equal(
        np.argmax(ds.test_y, axis=1),
        synthetic_labels(FASHION_TEST_COUNTS, 32, seed=456, split=1),
    )
