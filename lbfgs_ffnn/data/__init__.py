from lbfgs_ffnn.data.idx import read_idx_images, read_idx_labels_onehot, write_idx_u8
from lbfgs_ffnn.data.datasets import (
    Dataset, load_fashion_mnist, load_mnist, synthetic_images_for_labels,
    synthetic_labels,
)

__all__ = [
    "read_idx_images",
    "read_idx_labels_onehot",
    "write_idx_u8",
    "Dataset",
    "load_mnist",
    "load_fashion_mnist",
    "synthetic_images_for_labels",
    "synthetic_labels",
]
