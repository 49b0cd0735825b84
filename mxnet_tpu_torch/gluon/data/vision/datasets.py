"""Vision datasets (reference
``python/mxnet/gluon/data/vision/datasets.py``).

Port of ``mxnet_tpu/gluon/data/vision/datasets.py``: the same files read
the same way, the same synthetic generator, and the same refusal to
download.  Images are host ``NDArray``s (a batch reaches the card once,
from the loader).

No-network environment: ``pretrained``-style auto-download is disabled;
datasets read the standard on-disk formats from ``root`` (MNIST idx files,
CIFAR binary batches) and raise a clear error when absent.  A
``synthetic=N`` escape hatch generates deterministic fake data with the real
shapes/dtypes so training-loop tests and benchmarks run hermetically (the
role the reference's ``--benchmark 1`` dummy iterators play, SURVEY.md §6).
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as onp

from ....base import MXNetError
from ....ndarray.ndarray import _host
from ..dataset import Dataset


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform, synthetic=0):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        if synthetic:
            self._make_synthetic(synthetic)
        else:
            self._get_data()

    def _make_synthetic(self, n):
        """Deterministic LEARNABLE synthetic data: each class is a fixed
        smooth prototype image (shared between train/test splits via a
        fixed seed) observed under random shift / brightness / pixel noise
        (per-split seed).  A ConvNet that learns shift-robust class
        structure generalizes to the test split, so synthetic-mode
        accuracy is a real signal — this backs the accuracy-parity gate
        when the sandbox has no dataset egress (BASELINE.md config 1)."""
        sample_rng = onp.random.RandomState(42 if self._train else 43)
        shape = self._synthetic_shape()
        ncls = self._num_classes()
        proto_rng = onp.random.RandomState(7)
        protos = proto_rng.rand(ncls, *shape).astype(onp.float32)
        for ax in (1, 2):                    # blur for spatial coherence
            for _ in range(2):
                protos = (onp.roll(protos, 1, axis=ax) + protos +
                          onp.roll(protos, -1, axis=ax)) / 3.0
        protos = (protos - protos.min()) / (onp.ptp(protos) + 1e-9) * 255
        labels = sample_rng.randint(0, ncls, size=(n,)).astype(onp.int32)
        data = onp.empty((n,) + tuple(shape), onp.uint8)
        chunk = 8192
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            blk = protos[labels[lo:hi]]
            dy = sample_rng.randint(-3, 4, size=hi - lo)
            dx = sample_rng.randint(-3, 4, size=hi - lo)
            for sy in range(-3, 4):
                for sx in range(-3, 4):
                    m = (dy == sy) & (dx == sx)
                    if m.any():
                        blk[m] = onp.roll(blk[m], (sy, sx), axis=(1, 2))
            bright = 0.7 + 0.6 * sample_rng.rand(
                hi - lo, 1, 1, 1).astype(onp.float32)
            noise = sample_rng.randn(hi - lo, *shape).astype(
                onp.float32) * 16.0
            data[lo:hi] = onp.clip(blk * bright + noise, 0,
                                   255).astype(onp.uint8)
        self._data = data
        self._label = labels

    def _synthetic_shape(self):
        raise NotImplementedError

    def _num_classes(self):
        return 10

    def _get_data(self):
        raise NotImplementedError

    def __len__(self):
        return len(self._label)

    def __getitem__(self, idx):
        x = _host(self._data[idx], "uint8")
        y = int(self._label[idx])
        if self._transform is not None:
            return self._transform(x, y)
        return x, y


class MNIST(_DownloadedDataset):
    """MNIST from idx(.gz) files in ``root`` (reference layout:
    train-images-idx3-ubyte.gz etc.)."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None, synthetic=0):
        super().__init__(root, train, transform, synthetic)

    def _synthetic_shape(self):
        return (28, 28, 1)

    @staticmethod
    def _read_idx(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic, = struct.unpack(">I", f.read(4))
            ndim = magic & 0xFF
            dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
            return onp.frombuffer(f.read(), dtype=onp.uint8).reshape(dims)

    def _find(self, base):
        for cand in (base, base + ".gz"):
            p = os.path.join(self._root, cand)
            if os.path.isfile(p):
                return p
        raise MXNetError(
            f"{base}(.gz) not found under {self._root}; downloads are "
            f"disabled in this environment — place the files there or use "
            f"synthetic=N")

    def _get_data(self):
        img_f, lbl_f = self._train_files if self._train else self._test_files
        imgs = self._read_idx(self._find(img_f))
        self._data = imgs[:, :, :, None]
        self._label = self._read_idx(self._find(lbl_f)).astype(onp.int32)


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None, synthetic=0):
        super().__init__(root, train, transform, synthetic)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from the python pickle batches or binary ``.bin`` format."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None, synthetic=0):
        super().__init__(root, train, transform, synthetic)

    def _synthetic_shape(self):
        return (32, 32, 3)

    def _batches(self):
        if self._train:
            return [f"data_batch_{i}" for i in range(1, 6)]
        return ["test_batch"]

    def _get_data(self):
        # python-pickle layout (cifar-10-batches-py)
        pydir = os.path.join(self._root, "cifar-10-batches-py")
        if os.path.isdir(pydir):
            data, labels = [], []
            for b in self._batches():
                with open(os.path.join(pydir, b), "rb") as f:
                    d = pickle.load(f, encoding="latin1")
                data.append(onp.asarray(d["data"], dtype=onp.uint8))
                labels.extend(d["labels"])
            raw = onp.concatenate(data).reshape(-1, 3, 32, 32)
            self._data = raw.transpose(0, 2, 3, 1)
            self._label = onp.asarray(labels, dtype=onp.int32)
            return
        # binary layout (cifar-10-batches-bin): 1 label byte + 3072 img bytes
        bindir = os.path.join(self._root, "cifar-10-batches-bin")
        names = [f"{b}.bin" for b in self._batches()]
        if os.path.isdir(bindir) or all(
                os.path.isfile(os.path.join(self._root, n)) for n in names):
            base = bindir if os.path.isdir(bindir) else self._root
            recs = []
            for n in names:
                with open(os.path.join(base, n), "rb") as f:
                    recs.append(onp.frombuffer(f.read(), dtype=onp.uint8)
                                .reshape(-1, 3073))
            raw = onp.concatenate(recs)
            self._label = raw[:, 0].astype(onp.int32)
            self._data = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            return
        raise MXNetError(
            f"CIFAR10 data not found under {self._root}; downloads are "
            f"disabled — place cifar-10-batches-py/ or *.bin there, or use "
            f"synthetic=N")


class CIFAR100(CIFAR10):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar100"),
                 fine_label=True, train=True, transform=None, synthetic=0):
        self._fine = fine_label
        super().__init__(root, train, transform, synthetic)

    def _num_classes(self):
        return 100 if self._fine else 20

    def _get_data(self):
        pydir = os.path.join(self._root, "cifar-100-python")
        if not os.path.isdir(pydir):
            raise MXNetError(
                f"CIFAR100 data not found under {self._root}; use synthetic=N")
        name = "train" if self._train else "test"
        with open(os.path.join(pydir, name), "rb") as f:
            d = pickle.load(f, encoding="latin1")
        raw = onp.asarray(d["data"], dtype=onp.uint8).reshape(-1, 3, 32, 32)
        self._data = raw.transpose(0, 2, 3, 1)
        key = "fine_labels" if self._fine else "coarse_labels"
        self._label = onp.asarray(d[key], dtype=onp.int32)


class ImageRecordDataset(Dataset):
    """Dataset over an image RecordIO file: samples are (image NDArray,
    label) decoded from packed IRHeader records."""

    def __init__(self, filename, flag=1, transform=None):
        from ..dataset import RecordFileDataset
        self._record = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __len__(self):
        return len(self._record)

    def __getitem__(self, idx):
        from .... import recordio
        from ....image import imdecode
        record = self._record[idx]
        header, img = recordio.unpack(record)
        label = header.label
        if hasattr(label, "size") and getattr(label, "size", 1) == 1:
            label = float(onp.asarray(label).reshape(-1)[0])
        x = imdecode(img, iscolor=self._flag)
        if self._transform is not None:
            return self._transform(x, label)
        return x, label


class ImageFolderDataset(Dataset):
    """``root/category/image.jpg`` folder layout (reference
    ``ImageFolderDataset``)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = (".jpg", ".jpeg", ".png", ".bmp")
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                if fname.lower().endswith(self._exts):
                    self.items.append((os.path.join(path, fname), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        from ....image import imread
        fname, label = self.items[idx]
        img = imread(fname, iscolor=self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageListDataset(Dataset):
    """Dataset from an explicit (path, label) list."""

    def __init__(self, root=".", imglist=None, flag=1):
        self._root = root
        self._flag = flag
        self.items = list(imglist or [])

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        from ....image import imread
        fname, label = self.items[idx]
        return imread(os.path.join(self._root, fname), iscolor=self._flag), label
