"""Dataset preparation (ref `DataPreprocess/`), port of
`cryptonets_tpu/data/preprocess.py`: MNIST idx files -> sparse TSV,
CIFAR-10 binary batches -> dense TSV, Caltech-101 image folders -> AlexNet
feature TSV (`data/alexnet.py`), all from local files (the reference's
DataPreprocess.exe downloads them; nothing here touches the network); and
seeded synthetic records, so the pipelines run without downloaded data
(same seed -> the reference's records): MNIST-like images, CIFAR-like
images and Caltech-101 feature vectors.

CLI:  python -m cryptonets_tpu_torch.data.preprocess MNIST|CIFAR|CAL [dir]
      [weights.pth]   (CAL: [--device cpu] after the arguments)
"""

from __future__ import annotations

import gzip
import os
import struct
import sys

import numpy as np


# ------------------------------------------------------------------ MNIST
def read_idx(path: str) -> np.ndarray:
    """An idx file (gzipped when the name ends in .gz) as a uint8 array of
    its dimensions (ref GetMNIST.cs:55-80)."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as fh:
        magic = struct.unpack(">I", fh.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", fh.read(4))[0] for _ in range(ndim)]
        return np.frombuffer(fh.read(), dtype=np.uint8).reshape(dims)


def mnist_to_sparse_tsv(images_path: str, labels_path: str, out_path: str):
    """MNIST -> `label dim idx:val ...` lines, tab-separated, the nonzero
    pixels only (the reference's sparse format)."""
    images = read_idx(images_path)
    labels = read_idx(labels_path)
    n, h, w = images.shape
    with open(out_path, "w") as out:
        for i in range(n):
            flat = images[i].ravel()
            toks = [str(int(labels[i])), str(h * w)]
            toks += [f"{j}:{int(flat[j])}" for j in np.nonzero(flat)[0]]
            out.write("\t".join(toks) + "\n")


def load_mnist_records(images_path: str, labels_path: str, count=None):
    """(label, 784 float pixels) records of an idx pair, the first `count`."""
    images = read_idx(images_path)
    labels = read_idx(labels_path)
    if count:
        images, labels = images[:count], labels[:count]
    return [(int(lb), im.ravel().astype(np.float64))
            for lb, im in zip(labels, images)]


# ------------------------------------------------------------------ CIFAR
def cifar_to_dense_tsv(batch_paths, out_path: str):
    """CIFAR-10 binary batches (3073-byte records: label, 3 x 32 x 32
    pixels) -> dense TSV lines, channel-major with x and y transposed
    (ref GetCIFAR.cs:16-51)."""
    with open(out_path, "w") as out:
        for path in batch_paths:
            raw = np.fromfile(path, dtype=np.uint8).reshape(-1, 3073)
            imgs = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 1, 3, 2)
            for lb, im in zip(raw[:, 0], imgs.reshape(-1, 3072)):
                out.write("\t".join([str(int(lb))] + [str(int(v)) for v in im])
                          + "\n")


def synthetic_mnist_records(count: int, seed: int = 0):
    """`count` (label, 784 float pixels) records: 28x28 uint8-valued
    images made of a few Gaussian blobs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        img = np.zeros((28, 28))
        for _ in range(rng.integers(3, 8)):
            cx, cy = rng.integers(4, 24, 2)
            yy, xx = np.mgrid[0:28, 0:28]
            img += 255.0 * np.exp(
                -((xx - cx) ** 2 + (yy - cy) ** 2) / rng.uniform(4, 16)
            )
        img = np.clip(img, 0, 255).round()
        out.append((int(rng.integers(0, 10)), img.ravel()))
    return out


def synthetic_cifar_records(count: int, seed: int = 0):
    """`count` (label, 3 * 32 * 32 float pixels) records: uniform uint8
    values, channel-major."""
    rng = np.random.default_rng(seed)
    return [
        (int(rng.integers(0, 10)),
         rng.integers(0, 256, 3 * 32 * 32).astype(np.float64))
        for _ in range(count)
    ]


def synthetic_feature_records(count: int, dim: int, seed: int = 0):
    """`count` (label below 102, `dim` non-negative float features)
    records: a stand-in for the AlexNet features of Caltech-101."""
    rng = np.random.default_rng(seed)
    return [
        (int(rng.integers(0, 102)), np.abs(rng.normal(0, 1.0, dim)))
        for _ in range(count)
    ]


def main(argv=None):
    """MNIST: `t10k-{images-idx3,labels-idx1}-ubyte.gz` in [dir] ->
    MNIST-28x28-test.txt; CIFAR: `test_batch.bin` -> cifar-test.txt; CAL:
    [dir] is the 101_ObjectCategories folder -> cal_deep_test.tsv, with an
    optional torchvision AlexNet state_dict for real features (ref
    GetCAL.cs:86-123).  Output files go to the working directory."""
    args = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i: i + 2]
    kind = args[0].upper() if args else ""
    src = args[1] if len(args) > 1 else "."
    if kind == "MNIST":
        mnist_to_sparse_tsv(
            os.path.join(src, "t10k-images-idx3-ubyte.gz"),
            os.path.join(src, "t10k-labels-idx1-ubyte.gz"),
            "MNIST-28x28-test.txt",
        )
    elif kind == "CIFAR":
        cifar_to_dense_tsv([os.path.join(src, "test_batch.bin")], "cifar-test.txt")
    elif kind == "CAL":
        from .alexnet import featurize_directory

        weights = args[2] if len(args) > 2 else None
        n = featurize_directory(src, "cal_deep_test.tsv", weights, device=device)
        print(f"cal_deep_test.tsv: {n} records"
              + ("" if weights else " (seeded-random featurizer weights;"
                 " pass a torchvision alexnet .pth for real features)"))
    else:
        print(__doc__)


if __name__ == "__main__":
    main()
