"""Image dataset with depth maps, labels, camera angles and feature embeddings
(a copy of `tdgp/data/dataset.py`, which is numpy and PIL only).

  - arrays come out NHWC
  - a thread-based prefetching BatchLoader feeds numpy batches; the loop
    overlaps host decode with device compute
  - the InfiniteSampler's index stream is rank-strided, so that each of
    several processes would read a disjoint share.

Item dict (matching ref dataset.py:126-141):
  image  [H, W, 3] uint8
  label  [c_dim] float32 one-hot (or [0])
  camera_angles [3] float32 (yaw mirrored under xflip, ref :157-163)
  depth  [H, W, 1] int32 in [0, 65535] (16-bit LeReS; 8-bit ZoeDepth x256)
  embedding [emb_dim] float32 (ResNet-50 features from .memmap)
"""
from __future__ import annotations

import json
import os
import threading
import queue as queue_mod
import zipfile
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import PIL.Image


def remove_root(fname: str, root_name: str) -> str:
    """ref dataset.py:365-375."""
    if fname == root_name or fname == '/' + root_name:
        return ''
    if fname.startswith(root_name + '/'):
        return fname[len(root_name) + 1:]
    if fname.startswith('/' + root_name + '/'):
        return fname[len(root_name) + 2:]
    return fname


class ImageFolderDataset:
    def __init__(self, path: str, resolution: Optional[int] = None,
                 use_labels: bool = False, use_depth: bool = False,
                 use_embeddings: bool = False, mirror: bool = False,
                 max_size: Optional[int] = None, random_seed: int = 0,
                 embeddings_path: str = '', embeddings_desc_path: str = '',
                 mean_yaw: float = 0.0):
        self._path = path
        self._zip: Optional[zipfile.ZipFile] = None
        self._lock = threading.Lock()
        self._use_labels = use_labels
        self._use_depth = use_depth
        self._use_embeddings = use_embeddings
        self._embeddings_path = embeddings_path
        self._embeddings_desc_path = embeddings_desc_path
        self._mean_yaw = mean_yaw  # for xflip yaw mirroring (ref :160-162)

        if os.path.isdir(path):
            self._type = 'dir'
            self._all_fnames = {os.path.relpath(os.path.join(root, f), start=path)
                                for root, _d, files in os.walk(path) for f in files}
        elif path.endswith('.zip'):
            self._type = 'zip'
            self._all_fnames = set(self._get_zip().namelist())
        else:
            raise IOError(f"Path must be a directory or zip: {path}")

        PIL.Image.init()
        exts = set(PIL.Image.EXTENSION.keys())
        self._image_fnames = sorted(
            f for f in self._all_fnames
            if os.path.splitext(f)[1].lower() in exts and not f.endswith('_depth.png'))
        if not self._image_fnames:
            raise IOError(f"No images found in {path}")
        self._name = os.path.splitext(os.path.basename(path))[0]

        probe = self._load_raw_image(0)
        if resolution is not None and probe.shape[0] != resolution:
            raise IOError(f"Images are {probe.shape[:2]}, expected {resolution}")
        self._raw_shape = (len(self._image_fnames),) + probe.shape

        self._raw_idx = np.arange(self._raw_shape[0], dtype=np.int64)
        if max_size is not None and self._raw_idx.size > max_size:
            np.random.RandomState(random_seed).shuffle(self._raw_idx)
            self._raw_idx = np.sort(self._raw_idx[:max_size])

        self._xflip = np.zeros(self._raw_idx.size, dtype=np.uint8)
        if mirror:
            self._raw_idx = np.tile(self._raw_idx, 2)
            self._xflip = np.concatenate([self._xflip, np.ones_like(self._xflip)])

        self._raw_labels: Optional[np.ndarray] = None
        self._raw_camera_angles: Optional[np.ndarray] = None
        self._embeddings: Optional[np.ndarray] = None
        self._idx2embidx: Optional[np.ndarray] = None

    # ------------------------------------------------------------- file io

    def _get_zip(self) -> zipfile.ZipFile:
        if self._zip is None:
            self._zip = zipfile.ZipFile(self._path)
        return self._zip

    def _open(self, fname: str):
        if self._type == 'dir':
            return open(os.path.join(self._path, fname), 'rb')
        return self._get_zip().open(fname, 'r')

    def close(self):
        if self._zip is not None:
            self._zip.close()
            self._zip = None

    def _load_raw_image(self, raw_idx: int) -> np.ndarray:
        fname = self._image_fnames[raw_idx]
        with self._lock, self._open(fname) as f:
            img = np.array(PIL.Image.open(f))
        if img.ndim == 2:
            img = img[:, :, None]
        if img.shape[2] == 1:
            img = np.repeat(img, 3, axis=2)
        return img  # [H, W, 3] uint8

    def _load_raw_depth(self, raw_idx: int) -> np.ndarray:
        """16-bit LeReS ([h,w,2] or [h,w]) / 8-bit ZoeDepth decode (ref :310-330)."""
        base = os.path.splitext(self._image_fnames[raw_idx])[0]
        with self._lock, self._open(f'{base}_depth.png') as f:
            depth = np.array(PIL.Image.open(f))
        assert depth.ndim in (2, 3), f"bad depth ndim {depth.ndim}"
        assert depth.dtype in (np.uint8, np.uint16), f"bad depth dtype {depth.dtype}"
        depth = depth[:, :, :1] if depth.ndim == 3 else depth[:, :, None]
        if depth.dtype == np.uint8:
            depth = depth.astype(np.uint16) * 256
        return depth.astype(np.int32)  # [H, W, 1]

    # ------------------------------------------------------------- metadata

    def _find_file(self, suffix: str) -> Optional[str]:
        files = [f for f in self._all_fnames if f.endswith(suffix)]
        assert len(files) <= 1, f"multiple {suffix} files"
        return files[0] if files else None

    def _load_field(self, field: str) -> Optional[np.ndarray]:
        meta = self._find_file('dataset.json')
        if meta is None:
            return None
        with self._open(meta) as f:
            values = json.load(f).get(field)
        if values is None:
            return None
        values = dict(values)
        return np.array([values[remove_root(f, self._name).replace('\\', '/')]
                         for f in self._image_fnames])

    def _get_raw_labels(self) -> np.ndarray:
        if self._raw_labels is None:
            labels = self._load_field('labels') if self._use_labels else None
            if labels is None:
                assert not self._use_labels, "labels requested but dataset.json has none"
                labels = np.zeros((self._raw_shape[0], 0), dtype=np.float32)
            else:
                labels = labels.astype({1: np.int64, 2: np.float32}[labels.ndim])
            self._raw_labels = labels
        return self._raw_labels

    def _get_raw_camera_angles(self) -> np.ndarray:
        if self._raw_camera_angles is None:
            angles = self._load_field('camera_angles')
            if angles is None:
                angles = np.zeros((self._raw_shape[0], 3), dtype=np.float32)
            self._raw_camera_angles = angles.astype(np.float32)
        return self._raw_camera_angles

    def _get_embeddings(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._embeddings is None:
            if self._use_embeddings:
                with open(self._embeddings_desc_path) as f:
                    desc = json.load(f)
                self._embeddings = np.memmap(self._embeddings_path, dtype='float32',
                                             mode='r', shape=tuple(desc['shape']))
                self._idx2embidx = np.array(
                    [desc['filepath_to_idx'][remove_root(f, self._name).replace('\\', '/')]
                     for f in self._image_fnames], dtype=np.int32)
            else:
                self._embeddings = np.zeros((self._raw_shape[0], 0), dtype=np.float32)
                self._idx2embidx = np.arange(self._raw_shape[0], dtype=np.int32)
        return self._idx2embidx, self._embeddings

    # ------------------------------------------------------------- item api

    def __len__(self) -> int:
        return self._raw_idx.size

    @property
    def name(self) -> str:
        return self._name

    @property
    def resolution(self) -> int:
        return self._raw_shape[1]

    @property
    def label_dim(self) -> int:
        labels = self._get_raw_labels()
        if labels.dtype == np.int64:
            return int(labels.max()) + 1
        return labels.shape[1]

    @property
    def has_depth(self) -> bool:
        return self._use_depth

    def get_label(self, idx: int) -> np.ndarray:
        label = self._get_raw_labels()[self._raw_idx[idx]]
        if label.dtype == np.int64:
            onehot = np.zeros(self.label_dim, dtype=np.float32)
            onehot[label] = 1
            return onehot
        return label.copy()

    def get_camera_angles(self, idx: int) -> np.ndarray:
        angles = self._get_raw_camera_angles()[self._raw_idx[idx]].copy()
        if self._xflip[idx]:
            angles[0] = -(angles[0] - self._mean_yaw) + self._mean_yaw
        return angles

    def get_depth(self, idx: int) -> np.ndarray:
        depth = self._load_raw_depth(self._raw_idx[idx])
        if self._xflip[idx]:
            depth = depth[:, ::-1]
        return depth.copy()

    def get_embedding(self, idx: int) -> np.ndarray:
        idx2emb, embs = self._get_embeddings()
        return np.array(embs[idx2emb[self._raw_idx[idx]]], dtype=np.float32)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        image = self._load_raw_image(self._raw_idx[idx])
        if self._xflip[idx]:
            image = image[:, ::-1]
        return {
            'image': image.copy(),
            'label': self.get_label(idx),
            'camera_angles': self.get_camera_angles(idx),
            'depth': (self.get_depth(idx) if self._use_depth
                      else np.zeros(image.shape[:2] + (1,), dtype=np.int32)),
            'embedding': self.get_embedding(idx),
        }


class InfiniteSampler:
    """Rank-strided, window-shuffled infinite index stream
    (ref src/torch_utils/misc.py:112-143)."""

    def __init__(self, dataset_size: int, rank: int = 0, num_replicas: int = 1,
                 shuffle: bool = True, seed: int = 0, window_size: float = 0.5):
        assert dataset_size > 0 and 0 <= rank < num_replicas
        self.dataset_size = dataset_size
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.seed = seed
        self.window_size = window_size

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.dataset_size)
        rnd = None
        window = 0
        if self.shuffle:
            rnd = np.random.RandomState(self.seed)
            rnd.shuffle(order)
            window = int(np.rint(order.size * self.window_size))
        idx = 0
        while True:
            i = idx % order.size
            if idx % self.num_replicas == self.rank:
                yield int(order[i])
            if window >= 2:
                j = (i - rnd.randint(window)) % order.size
                order[i], order[j] = order[j], order[i]
            idx += 1


class BatchLoader:
    """Thread-prefetched numpy batch iterator."""

    def __init__(self, dataset: ImageFolderDataset, batch_size: int,
                 rank: int = 0, num_replicas: int = 1, seed: int = 0,
                 prefetch: int = 3, num_threads: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rank = rank
        self.num_replicas = num_replicas
        self._sampler = iter(InfiniteSampler(len(dataset), rank=rank,
                                             num_replicas=num_replicas, seed=seed))
        self._queue: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._idx_lock = threading.Lock()
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(num_threads)]
        for t in self._threads:
            t.start()

    def _next_indices(self) -> List[int]:
        with self._idx_lock:
            return [next(self._sampler) for _ in range(self.batch_size)]

    def _worker(self):
        while not self._stop.is_set():
            try:
                indices = self._next_indices()
                items = [self.dataset[i] for i in indices]
                batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
                # raw dataset indices ride along for observability; the
                # training loop pops them before the step
                batch['_indices'] = np.asarray(indices, dtype=np.int64)
            except Exception as e:  # noqa: BLE001 - handed to the consumer
                batch = e
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=0.5)
                    break
                except queue_mod.Full:
                    continue
            if isinstance(batch, Exception):
                return

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        """The next batch; a worker's failure is raised here."""
        batch = self._queue.get()
        if isinstance(batch, Exception):
            self.close()
            raise RuntimeError('a batch loader worker failed') from batch
        return batch

    def close(self):
        self._stop.set()


def normalize_batch(batch: Dict[str, np.ndarray],
                    compact: bool = False) -> Dict[str, np.ndarray]:
    """uint8/uint16 -> float32 training ranges.

    compact=True keeps the raw integer image (u8) and depth (u16) instead,
    4x fewer bytes to copy to the device, and leaves the float conversion
    to the device (`tdgp_torch.training.loop.to_device`), with the same
    result bit for bit.
    """
    if compact:
        out = {
            'img': batch['image'],                       # uint8 passthrough
            'depth': batch['depth'].astype(np.uint16),   # values <= 65535
            'c': batch['label'].astype(np.float32),
            'camera_angles': batch['camera_angles'].astype(np.float32),
            'embs': batch['embedding'].astype(np.float32),
        }
    else:
        out = {
            'img': batch['image'].astype(np.float32) / 127.5 - 1.0,
            'depth': batch['depth'].astype(np.float32) / 65536 * 2.0 - 1.0,
            'c': batch['label'].astype(np.float32),
            'camera_angles': batch['camera_angles'].astype(np.float32),
            'embs': batch['embedding'].astype(np.float32),
        }
    if '_indices' in batch:
        out['_indices'] = batch['_indices']
    return out
