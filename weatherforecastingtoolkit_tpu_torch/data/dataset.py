"""SEVIR map-style dataset: windows -> preprocessed host batches
(counterpart of weatherforecastingtoolkit_tpu/data/dataset.py; numpy on the
host, as there).

Composes the catalog EventIndex, WindowIndex math, and SEVIRReader into the
reference's `SEVIRDataLoader`/`SEVIRTorchDataset` capability
(reference pipeline/datasets/sevir/sevir.py:104-908,980-1067):
sequent/random/index sampling over sliding windows, '01'/'sevir' rescale,
layout transforms, runtime downsampling, and augmentation modes 0/1/2.

Deviations from the reference:
  * returns numpy (host) arrays; device placement is the prefetcher's job;
  * `rescale='01_uint8'` defers the /255 to the device (see hdf5.py docstring);
  * augmentation is pure numpy with an explicit per-sample PRNG derived from
    (seed, epoch, index) — deterministic and worker-count independent, unlike
    torch's global-RNG transforms (the reference probes exactly this hazard in
    notebooks/det.py).
"""

from __future__ import annotations

import datetime
from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np

from ..ops.layout import change_layout
from .catalog import EventIndex, build_event_index
from .constants import (PREPROCESS_OFFSET_01, PREPROCESS_OFFSET_SEVIR,
                        PREPROCESS_SCALE_01, PREPROCESS_SCALE_SEVIR,
                        VALID_LAYOUTS)
from .hdf5 import SEVIRReader
from .windows import WindowIndex, shard_event_range


def preprocess_array(data: np.ndarray, img_type: str, rescale: str = "01") -> np.ndarray:
    """Raw (H, W, T) -> float32 rescaled (reference sevir/sevir.py:626-666)."""
    if rescale == "sevir":
        scale, offset = PREPROCESS_SCALE_SEVIR[img_type], PREPROCESS_OFFSET_SEVIR[img_type]
    elif rescale == "01":
        scale, offset = PREPROCESS_SCALE_01[img_type], PREPROCESS_OFFSET_01[img_type]
    elif rescale == "01_uint8":
        return data  # raw passthrough; device dequantizes
    else:
        raise ValueError(f"Invalid rescale option: {rescale}")
    return (scale * (data.astype(np.float32) + offset)).astype(np.float32)


def process_back(data, img_type: str, rescale: str = "01"):
    """Inverse of preprocess (reference sevir/sevir.py:668-698)."""
    if rescale == "sevir":
        scale, offset = PREPROCESS_SCALE_SEVIR[img_type], PREPROCESS_OFFSET_SEVIR[img_type]
    elif rescale in ("01", "01_uint8"):
        scale, offset = PREPROCESS_SCALE_01[img_type], PREPROCESS_OFFSET_01[img_type]
    else:
        raise ValueError(f"Invalid rescale option: {rescale}")
    return data / scale - offset


def downsample_hwt(data: np.ndarray, t_factor: int = 1, h_factor: int = 1,
                   w_factor: int = 1, method: str = "avg") -> np.ndarray:
    """(H, W, T) downsampling: subsample T, avg/max-pool H and W
    (reference sevir/sevir.py:720-762 runtime path & :450-493 offline path)."""
    data = data[:, :, ::t_factor]
    h, w, t = data.shape
    h2, w2 = h // h_factor, w // w_factor
    data = data[: h2 * h_factor, : w2 * w_factor]
    blocks = data.reshape(h2, h_factor, w2, w_factor, t)
    if method == "avg":
        return blocks.mean(axis=(1, 3)).astype(np.float32)
    if method == "max":
        return blocks.max(axis=(1, 3))
    raise ValueError(method)


def augment_thw(data: np.ndarray, mode: str, rng: np.random.Generator,
                interp: str = "nearest") -> np.ndarray:
    """Augment a (T, H, W) stack.

    mode '0': identity. mode '1': random h/v flips + continuous rotation in
    [-180, 180). mode '2': random h/v flips + a fixed rotation from
    {0, 90, 180, 270} (reference sevir/sevir.py:1034-1050, TransformsFixRotation
    :910-928).

    `interp` selects mode-'1' resampling: 'nearest' matches the reference —
    torchvision RandomRotation defaults to InterpolationMode.NEAREST
    (reference sevir/sevir.py:1037-1041) and never creates pixel values that
    weren't in the frame; 'bilinear' is available as a smoother opt-in.
    """
    if mode == "0":
        return data
    if mode not in ("1", "2"):
        raise NotImplementedError(f"aug_mode {mode}")
    if rng.random() < 0.5:
        data = data[:, :, ::-1]  # horizontal flip
    if rng.random() < 0.5:
        data = data[:, ::-1, :]  # vertical flip
    if mode == "2":
        k = int(rng.integers(0, 4))
        data = np.rot90(data, k=k, axes=(1, 2))
    else:
        from scipy.ndimage import rotate

        if interp not in ("nearest", "bilinear"):
            raise ValueError(f"aug interp {interp!r}")
        angle = float(rng.uniform(-180.0, 180.0))
        data = rotate(data, angle, axes=(2, 1), reshape=False,
                      order=0 if interp == "nearest" else 1,
                      mode="constant", cval=0.0)
    return np.ascontiguousarray(data)


class SEVIRDataset:
    """Map-style dataset over sliding windows of colocated SEVIR events.

    __getitem__(i) returns {img_type: array in `layout` without the N axis}
    plus the raw (event, window) provenance under '_meta' when requested.
    """

    def __init__(
        self,
        catalog: Union[str, Mapping[str, Sequence], EventIndex],
        data_dir: str,
        data_types: Sequence[str] = ("vil",),
        seq_len: int = 25,
        raw_seq_len: int = 49,
        stride: int = 12,
        layout: str = "NTHWC",
        num_shard: int = 1,
        rank: int = 0,
        split_mode: str = "uneven",
        start_date: Optional[datetime.datetime] = None,
        end_date: Optional[datetime.datetime] = None,
        datetime_filter=None,
        catalog_filter="default",
        shuffle: bool = False,
        shuffle_seed: int = 1,
        rescale_method: str = "01",
        downsample: Optional[Dict[str, Sequence[int]]] = None,
        aug_mode: str = "0",
        aug_seed: int = 0,
        aug_interp: str = "nearest",
        verbose: bool = False,
    ):
        if layout not in VALID_LAYOUTS:
            raise ValueError(f"Invalid layout {layout!r}; must be one of {VALID_LAYOUTS}")
        if isinstance(catalog, EventIndex):
            index = catalog
        else:
            index = build_event_index(catalog, data_types, start_date, end_date,
                                      datetime_filter, catalog_filter)
        if shuffle:
            index = index.shuffled(shuffle_seed)
        start_ev, end_ev = shard_event_range(len(index), num_shard, rank, split_mode)
        self.events = index.subset(start_ev, min(end_ev, len(index)))
        # 'ceil' mode may ask for more events than exist; wrap duplicates
        self._ceil_pad = max(0, end_ev - len(index))
        self.data_types = tuple(data_types)
        self.layout = layout
        self.rescale_method = rescale_method
        self.downsample = downsample or {}
        self.aug_mode = aug_mode
        self.aug_seed = aug_seed
        self.aug_interp = aug_interp
        self.epoch = 0  # bump between epochs for fresh augmentation draws
        self.windows = WindowIndex(
            num_events=len(self.events) + self._ceil_pad,
            raw_seq_len=raw_seq_len, seq_len=seq_len, stride=stride)
        self.reader = SEVIRReader(data_dir, verbose=verbose)

    def __len__(self) -> int:
        return len(self.windows)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def _event(self, event_idx: int):
        return self.events[event_idx % len(self.events)]

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        event_idx, t_slice = self.windows.locate(index)
        event = self._event(event_idx)
        out: Dict[str, np.ndarray] = {}
        aug_rng = None
        if self.aug_mode != "0":
            aug_rng = np.random.default_rng(
                np.random.SeedSequence([self.aug_seed, self.epoch, index]))
        for t in self.data_types:
            arr = self.reader.read_window(event, t, t_slice)  # (H, W, Tw)
            arr = preprocess_array(arr, t, self.rescale_method)
            if t in self.downsample:
                arr = downsample_hwt(arr, *self.downsample[t])
            if aug_rng is not None:
                arr = augment_thw(arr.transpose(2, 0, 1), self.aug_mode,
                                  aug_rng, self.aug_interp).transpose(1, 2, 0)
            # host layout transform: HWT -> target layout sans batch axis
            transformed = change_layout(arr[None], "NHWT", self.layout)
            out[t] = transformed.take(0, axis=self.layout.index("N"))
        return out


class SEVIRSequentIterator:
    """Streaming batch iterator over a SEVIRDataset-like map dataset.

    The reference SEVIRDataLoader's iterator interface
    (reference sevir/sevir.py:595-849): 'sequent' mode walks windows in order
    and, at the dataset tail, pads the final batch and returns a per-sample
    boolean 'mask' (True = real data); 'random' mode draws uniform
    (event, window) samples forever. `reset()` restarts an epoch.
    """

    def __init__(self, dataset, batch_size: int, sample_mode: str = "sequent",
                 seed: int = 0):
        if sample_mode not in ("sequent", "random"):
            raise ValueError(f"Invalid sample_mode {sample_mode!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.sample_mode = sample_mode
        self._rng = np.random.default_rng(seed)
        self._cursor = 0

    def reset(self) -> None:
        self._cursor = 0

    @property
    def use_up(self) -> bool:
        return self.sample_mode == "sequent" and self._cursor >= len(self.dataset)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        n = len(self.dataset)
        if self.sample_mode == "random":
            idxs = self._rng.integers(0, n, self.batch_size)
            mask = None
        else:
            if self.use_up:
                raise StopIteration
            idxs = np.arange(self._cursor,
                             min(self._cursor + self.batch_size, n))
            self._cursor += self.batch_size
            pad = self.batch_size - len(idxs)
            if pad > 0:
                mask = [True] * len(idxs) + [False] * pad
                idxs = np.concatenate([idxs, np.zeros(pad, dtype=int)])
            else:
                mask = None
        samples = [self.dataset[int(i)] for i in idxs]
        batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        if mask is not None:
            # zero out padded entries like the reference's zero-pad
            m = np.asarray(mask)
            for k in batch:
                batch[k] = batch[k] * m.reshape((-1,) + (1,) * (batch[k].ndim - 1))
            batch["mask"] = mask
        return batch
