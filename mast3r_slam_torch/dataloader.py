"""Dataset loaders (TUM / EuRoC / image folder / video) and the prefetching
host pipeline: the port's own copy of ``mast3r_slam_tpu/dataloader.py``.

Same format detection, same `dataset.subsample` / `dataset.reverse` rules.
`PrefetchLoader` decodes and preprocesses frames i+1..i+depth in a background
thread while the card works on frame i; it takes the native C++ preprocessing
when that library builds (`mast3r_slam_torch.native`), else PIL. PIL (image
files) and cv2 (video) are imported only when a dataset needs them.
"""

from __future__ import annotations

import abc
import queue
import threading
from pathlib import Path
from typing import Iterator

import numpy as np

from mast3r_slam_torch.config import get_config

IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".tiff", ".webp"}


class Dataset(abc.ABC):
    """`len(ds)`; `ds[i] -> (timestamp: float, rgb: uint8 [H, W, 3])`."""

    @abc.abstractmethod
    def __len__(self) -> int: ...

    @abc.abstractmethod
    def __getitem__(self, idx: int) -> tuple[float, np.ndarray]: ...

    def __iter__(self) -> Iterator[tuple[float, np.ndarray]]:
        for i in range(len(self)):
            yield self[i]

    def _apply_config(self, indices: list, timestamps: list | None = None):
        cfg = get_config().dataset
        indices = indices[:: max(1, cfg.subsample)]
        if timestamps is not None:
            timestamps = timestamps[:: max(1, cfg.subsample)]
        if cfg.reverse:
            indices = indices[::-1]
            if timestamps is not None:
                timestamps = timestamps[::-1]
        return indices, timestamps


def _read_rgb(path: Path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


class FolderDataset(Dataset):
    """Sorted image files in a directory."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        files = sorted(
            p for p in self.path.iterdir() if p.suffix.lower() in IMG_EXTS
        )
        self.files, _ = self._apply_config(files)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int):
        return float(idx), _read_rgb(self.files[idx])


class TUMDataset(Dataset):
    """TUM RGB-D: rgb.txt / associated.txt or rgb/ glob."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        files: list[Path] = []
        stamps: list[float] = []
        assoc = self.path / "associated.txt"
        rgb_txt = self.path / "rgb.txt"
        listing = assoc if assoc.exists() else rgb_txt
        if listing.exists():
            for line in listing.read_text().splitlines():
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                stamps.append(float(parts[0]))
                files.append(self.path / parts[1])
        else:
            files = sorted((self.path / "rgb").glob("*.png"))
            stamps = [float(f.stem) for f in files]
        self.files, self.stamps = self._apply_config(files, stamps)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int):
        return self.stamps[idx], _read_rgb(self.files[idx])

    def groundtruth(self):
        """(timestamps, poses [N, 8] Sim3) from the sequence's
        groundtruth.txt, for ATE evaluation (`utils.export.ate_rmse`)."""
        from mast3r_slam_torch.utils.export import load_trajectory_tum

        gt = self.path / "groundtruth.txt"
        if not gt.exists():
            raise FileNotFoundError(gt)
        return load_trajectory_tum(gt)


class EuRoCDataset(Dataset):
    """EuRoC MAV: mav0/cam0/data/*.png, ns timestamps in filenames."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        files = sorted((self.path / "mav0" / "cam0" / "data").glob("*.png"))
        stamps = [float(f.stem) / 1e9 for f in files]
        self.files, self.stamps = self._apply_config(files, stamps)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int):
        return self.stamps[idx], _read_rgb(self.files[idx])


class VideoDataset(Dataset):
    """OpenCV video capture (cv2 imported when a video is opened)."""

    def __init__(self, path: str | Path):
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError("opencv required for video datasets") from e
        self._cv2 = cv2
        self.path = str(path)
        cap = cv2.VideoCapture(self.path)
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        cap.release()
        self.indices, _ = self._apply_config(list(range(n)))

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int):
        cv2 = self._cv2
        frame_idx = self.indices[idx]
        cap = cv2.VideoCapture(self.path)
        cap.set(cv2.CAP_PROP_POS_FRAMES, frame_idx)
        ok, bgr = cap.read()
        cap.release()
        if not ok:
            raise IndexError(f"failed to read frame {frame_idx}")
        return frame_idx / self.fps, cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def load_dataset(path: str | Path) -> Dataset:
    """Auto-detect the format: a file is a video; a directory with mav0/ is
    EuRoC; with rgb.txt, associated.txt or rgb/ it is TUM; else a folder."""
    path = Path(path)
    if path.is_file():
        return VideoDataset(path)
    if (path / "mav0").exists():
        return EuRoCDataset(path)
    if (path / "rgb.txt").exists() or (path / "associated.txt").exists() or (
        path / "rgb"
    ).is_dir():
        return TUMDataset(path)
    return FolderDataset(path)


class PrefetchLoader:
    """Background host pipeline: decode + resize ahead of the card.

    Yields (timestamp, processed: dict from models.preprocess.resize_img[_native]).
    """

    _STOP = object()
    _ERROR = object()  # sentinel: next queue item is the worker's exception

    def __init__(
        self,
        dataset: Dataset,
        img_size: int | None = None,
        depth: int | None = None,
        patch: int = 16,
    ):
        cfg = get_config()
        self.dataset = dataset
        self.img_size = img_size or cfg.dataset.img_size
        self.depth = depth or cfg.runtime.prefetch_depth
        self.patch = patch  # crop alignment (16 ViT-L, 14 DUNE)
        self._thread: threading.Thread | None = None

    def _worker(self, q: queue.Queue, max_frames: int | None):
        from mast3r_slam_torch import native
        from mast3r_slam_torch.models.preprocess import resize_img, resize_img_native

        prep = resize_img_native if native.native_available() else resize_img
        n = len(self.dataset) if max_frames is None else min(len(self.dataset), max_frames)
        try:
            for i in range(n):
                ts, rgb = self.dataset[i]
                q.put((ts, prep(rgb, self.img_size, patch=self.patch)))
        except BaseException as e:  # noqa: BLE001 — must cross the thread
            # a decode error in the worker surfaces at the consumer instead
            # of silently truncating the sequence
            q.put(self._ERROR)
            q.put(e)
        finally:
            q.put(self._STOP)

    def __call__(self, max_frames: int | None = None):
        # Fresh queue per invocation: after an error re-raise the worker's
        # trailing _STOP sentinel would otherwise linger in a shared queue
        # and make the next __call__ yield zero frames.
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._thread = threading.Thread(
            target=self._worker, args=(q, max_frames), daemon=True
        )
        self._thread.start()
        while True:
            item = q.get()
            if item is self._ERROR:
                raise q.get()
            if item is self._STOP:
                break
            yield item
