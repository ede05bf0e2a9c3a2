"""360-image dataset with a difficulty-balanced accumulation-window sampler.

The port of the JAX package's ``train/dataset.py`` (numpy only);
behavioral reference test/SphereDataset.py. The reference's
MyDistributeSampler (:35-118) reshuffles until every window of
batch*world*acc_batch images has a total "difficulty" of at least
mean*window, by greedy swaps against a per-image difficulty dict. The
epoch permutations are numpy's ``RandomState(seed + epoch)``, so the port
visits the images in the JAX package's order.
"""

from __future__ import annotations

import os
import pickle

import numpy as np


def load_image(path: str, hw=(512, 1024)) -> np.ndarray:
    """(3, H, W) float32 in [0,1]; BGR channel order like the reference
    (cv2.imread; SphereDataset.py:29-33, pseudo_codec.py:215-217). A
    ``.npy`` file holds (H, W, 3) values in [0, 255] and is not resized;
    other files need ``cv2``."""
    if path.endswith(".npy"):
        img = np.load(path)
    else:
        import cv2
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        if img.shape[:2] != hw:
            img = cv2.resize(img, (hw[1], hw[0]),
                             interpolation=cv2.INTER_CUBIC)
    return img.transpose(2, 0, 1).astype(np.float32) / 255.0


class SphereDataset:
    def __init__(self, img_dir: str, list_file: str, hw=(512, 1024)):
        with open(list_file) as f:
            self.files = [ln.rstrip("\n") for ln in f if ln.strip()]
        self.img_dir = img_dir
        self.hw = hw

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> np.ndarray:
        return load_image(os.path.join(self.img_dir, self.files[idx]),
                          self.hw)


class BalancedWindowSampler:
    """Shuffle, then repair windows so each accumulation window's total
    difficulty clears the threshold (MyDistributeSampler.check_modify)."""

    def __init__(self, dataset: SphereDataset, difficulty_dict: str | dict,
                 world_size: int, rank: int, batch_size: int,
                 acc_batch: int = 1, mean: float = 1.4, seed: int = 0,
                 shuffle: bool = True):
        if isinstance(difficulty_dict, str):
            with open(difficulty_dict, "rb") as f:
                difficulty_dict = pickle.load(f)
        names = [f.replace("npy", "png") for f in dataset.files]
        self.diff = np.array([difficulty_dict.get(n, mean) for n in names],
                             dtype=np.float64)
        self.ws = batch_size * world_size * acc_batch
        self.thr = mean * self.ws
        self.world_size = world_size
        self.rank = rank
        self.seed = seed
        self.shuffle = shuffle
        self.n = len(dataset)

    def _repair(self, idxs: np.ndarray) -> bool:
        ln = len(idxs) // self.ws
        if ln == 0:
            return True
        win = idxs[: ln * self.ws].reshape(ln, self.ws)
        sums = self.diff[win].sum(axis=1)
        for i in range(ln):
            guard = 0
            while sums[i] < self.thr:
                # swap this window's easiest image with the hardest image of
                # the richest window that stays above threshold
                mi = int(np.argmin(self.diff[win[i]]))
                donors = np.where(sums > self.thr + 0.618)[0]
                donors = donors[donors != i]
                if donors.size == 0 or guard > 4 * self.ws:
                    return False
                k = int(donors[np.argmax(sums[donors])])
                gains = self.diff[win[k]] - self.diff[win[i, mi]]
                ok = np.where(sums[k] - gains > self.thr)[0]
                if ok.size == 0:
                    return False
                kj = int(ok[np.argmax(self.diff[win[k]][ok])])
                win[i, mi], win[k, kj] = win[k, kj], win[i, mi]
                sums[i] = self.diff[win[i]].sum()
                sums[k] = self.diff[win[k]].sum()
                guard += 1
        idxs[: ln * self.ws] = win.reshape(-1)
        return True

    def epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.RandomState(self.seed + epoch)
        for _ in range(16):
            idxs = (rng.permutation(self.n) if self.shuffle
                    else np.arange(self.n))
            if self._repair(idxs):
                break
        # per-rank strided shard (DistributedSampler layout)
        return idxs[self.rank::self.world_size]


def batch_iterator(dataset: SphereDataset, indices, batch_size: int,
                   acc_batch: int = 1):
    """Yields (acc_batch, batch_size, 3, H, W) macro-batches."""
    step = batch_size * acc_batch
    for s in range(0, len(indices) - step + 1, step):
        chunk = indices[s: s + step]
        imgs = np.stack([dataset[int(i)] for i in chunk])
        yield imgs.reshape(acc_batch, batch_size, *imgs.shape[1:])
