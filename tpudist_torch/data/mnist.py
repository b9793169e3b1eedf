"""MNIST ingestion without torchvision (the port's copy of
:mod:`tpudist.data.mnist`, array for array):

* a numpy IDX reader for the standard ``train-images-idx3-ubyte`` files
  (gzipped or raw; raw files through the native parser of
  :mod:`tpudist_torch.data.native` when it builds) when a local copy
  exists (``TPUDIST_MNIST_DIR`` or ``./data/MNIST/raw``);
* a deterministic synthetic stand-in (class prototypes plus noise) for
  runs with no dataset and no download;
* ``data/real_digits.npz``, real handwritten digits committed to the
  repo (see ``scripts/make_real_digits.py``).

Every path normalises with MNIST's ``(0.1307, 0.3081)`` and gives NHWC
float32 images ``[N, 28, 28, 1]`` and int32 labels; the models do the
layout.  Nothing here downloads.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct
from pathlib import Path

import numpy as np

MNIST_MEAN = 0.1307
MNIST_STD = 0.3081

_FILES = {
    "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}
_REPO = Path(__file__).resolve().parents[2]


@dataclasses.dataclass(frozen=True)
class Dataset:
    """An in-memory image-classification dataset: normalised float32
    images ``[N, 28, 28, 1]`` (NHWC), int32 labels ``[N]``."""

    images: np.ndarray
    labels: np.ndarray
    name: str = "dataset"

    def __len__(self) -> int:
        return len(self.labels)

    @property
    def num_classes(self) -> int:
        return int(self.labels.max()) + 1


def _read_idx(path: Path) -> np.ndarray:
    if path.suffix != ".gz":  # raw files: the native parser when it builds
        from tpudist_torch.data.native import read_idx_native

        arr = read_idx_native(path)
        if arr is not None:
            return arr
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0:
            raise ValueError(f"{path}: bad IDX magic")
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dtypes = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
                  0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}
        data = np.frombuffer(
            f.read(), dtype=np.dtype(dtypes[dtype_code]).newbyteorder(">"))
        return data.reshape(dims)


def _find(directory: Path, stem: str) -> Path | None:
    for cand in (directory / stem, directory / (stem + ".gz")):
        if cand.exists():
            return cand
    return None


def _normalize(images_u8: np.ndarray) -> np.ndarray:
    x = images_u8.astype(np.float32) / 255.0
    x = (x - MNIST_MEAN) / MNIST_STD
    return x.reshape(*x.shape[:3], 1) if x.ndim == 3 else x


def load_mnist_idx(directory: str | os.PathLike,
                   split: str = "train") -> Dataset:
    """Load real MNIST from IDX files in ``directory``."""
    directory = Path(directory)
    img_stem, lbl_stem = _FILES[split]
    img_path, lbl_path = _find(directory, img_stem), _find(directory,
                                                           lbl_stem)
    if img_path is None or lbl_path is None:
        raise FileNotFoundError(
            f"MNIST {split} IDX files not found in {directory}")
    images = _normalize(_read_idx(img_path))
    labels = _read_idx(lbl_path).astype(np.int32)
    return Dataset(images=images, labels=labels, name=f"mnist-{split}")


def synthetic_mnist(split: str = "train", n: int | None = None,
                    seed: int = 0, noise: float = 0.35) -> Dataset:
    """Deterministic MNIST stand-in: 10 fixed random prototype digits,
    each sample = prototype + gaussian noise, clipped to [0, 1] and
    normalised as the real data.  Train and test draw disjoint sample
    streams from the same class-conditional distribution."""
    n = n if n is not None else (60_000 if split == "train" else 10_000)
    proto_rng = np.random.default_rng(seed)  # prototypes shared by splits
    protos = proto_rng.random((10, 28, 28), dtype=np.float32)
    protos = (protos > 0.72).astype(np.float32)  # sparse strokes
    sample_rng = np.random.default_rng(
        seed + (1 if split == "train" else 2) * 7919)
    labels = sample_rng.integers(0, 10, size=n).astype(np.int32)
    imgs = protos[labels] + noise * sample_rng.standard_normal(
        (n, 28, 28), dtype=np.float32)
    imgs = np.clip(imgs, 0.0, 1.0)
    images = ((imgs - MNIST_MEAN) / MNIST_STD).reshape(n, 28, 28, 1)
    return Dataset(images=images, labels=labels,
                   name=f"synthetic-mnist-{split}")


def load_real_digits(split: str = "train",
                     path: str | os.PathLike | None = None,
                     test_fraction: float = 0.15) -> Dataset:
    """The committed real handwritten digits, ``data/real_digits.npz``
    (the UCI digits set, upsampled 8×8 → 28×28 and stored uint8), found
    relative to the repo.  Not MNIST, but real pen strokes.  The file
    stores a fixed shuffle; ``split`` takes the head ("train") or the
    last ``test_fraction`` ("test")."""
    if split not in ("train", "test"):
        raise KeyError(f"unknown split {split!r} (expected train|test)")
    p = Path(path) if path else _REPO / "data" / "real_digits.npz"
    with np.load(p) as z:
        images_u8, labels = z["images"], z["labels"].astype(np.int32)
    n_test = int(len(labels) * test_fraction)
    cut = len(labels) - n_test  # not -n_test: slice(None, -0) is empty
    sl = slice(None, cut) if split == "train" else slice(cut, None)
    return Dataset(images=_normalize(images_u8[sl]), labels=labels[sl],
                   name=f"real-digits-{split}")


def load_mnist(split: str = "train", data_dir: str | None = None,
               n: int | None = None) -> Dataset:
    """Real MNIST when IDX files are available locally, the synthetic
    stand-in otherwise."""
    candidates = [data_dir, os.environ.get("TPUDIST_MNIST_DIR"),
                  "data/MNIST/raw", "data"]
    for cand in candidates:
        if cand and Path(cand).is_dir():
            try:
                ds = load_mnist_idx(cand, split)
                return Dataset(ds.images[:n], ds.labels[:n],
                               ds.name) if n else ds
            except FileNotFoundError:
                continue
    return synthetic_mnist(split, n=n)
