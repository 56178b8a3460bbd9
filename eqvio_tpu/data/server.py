"""Data serving: stamp-ordered measurement stream with async image prefetch.

Replaces the reference data-server family (``SimpleDataServer`` /
``ThreadedDataServer``, ``src/dataserver/*.cpp``): a background thread
decodes images ahead of the consumer into a bounded queue — the host-side
producer that keeps the device fed, the analogue of
``ThreadedDataServer.cpp:20-116``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, NamedTuple

import numpy as np


class Measurement(NamedTuple):
    kind: str  # "imu" | "image"
    stamp: float
    data: object  # IMU row (gyr, acc) or decoded image array
    index: int


def create_dataset_reader(mode: str, dataset_dir: str, camera_yaml: str | None = None,
                          camera_lag: float = 0.0):
    """Factory mirroring the reference ``createDatasetReader``
    (``dataservers.h:35-55``). ``camera_lag`` shifts image stamps earlier by
    the image-vs-IMU latency (reference ``DatasetReaderBase.h:71``, applied
    per reader, e.g. ``ASLDatasetReader.cpp:71``)."""
    reader = _create_reader(mode, dataset_dir, camera_yaml)
    if camera_lag:
        from .asl import ImageSeq

        reader.images = ImageSeq(
            reader.images.stamps - camera_lag, reader.images.paths
        )
    return reader


def _create_reader(mode: str, dataset_dir: str, camera_yaml: str | None):
    mode = mode.lower()
    if mode in ("asl", "euroc"):
        from .asl import ASLDatasetReader

        return ASLDatasetReader(dataset_dir, camera_yaml)
    if mode in ("uzhfpv", "uzh"):
        from .uzhfpv import UZHFPVDatasetReader

        return UZHFPVDatasetReader(dataset_dir, camera_yaml)
    if mode in ("anu", "ap"):
        from .anu import APDatasetReader

        return APDatasetReader(dataset_dir, camera_yaml)
    if mode in ("ros", "rosbag"):
        from .rosbag import RosbagDatasetReader

        return RosbagDatasetReader(dataset_dir, camera_yaml)
    if mode == "hilti":
        from .rosbag import HiltiDatasetReader

        return HiltiDatasetReader(dataset_dir, camera_yaml)
    raise ValueError(
        f"unknown dataset mode {mode!r} (use asl | uzhfpv | anu | rosbag | hilti)"
    )


class DataServer:
    """Stamp-ordered merged stream of IMU and (prefetched) image measurements."""

    def __init__(self, reader, start_time: float | None = None,
                 stop_time: float | None = None, queue_size: int = 64):
        self.reader = reader
        self.start_time = start_time
        self.stop_time = stop_time
        self.queue_size = queue_size

    def __iter__(self) -> Iterator[Measurement]:
        imu = self.reader.imu
        images = self.reader.images

        lo = -np.inf if self.start_time is None else self.start_time
        hi = np.inf if self.stop_time is None else self.stop_time

        img_idx = [i for i, s in enumerate(images.stamps) if lo <= s <= hi]
        imu_idx = [i for i, s in enumerate(imu.stamps) if lo - 0.1 <= s <= hi]

        # background decoder (ThreadedDataServer equivalent): the native C++
        # prefetcher when available (PNG frames), else a Python thread that
        # decodes through the reader (png.py)
        native_iter = None
        paths = [images.paths[i] for i in img_idx]
        if paths and all(str(p).lower().endswith(".png") for p in paths):
            from . import native_loader

            if native_loader.available():
                try:
                    native_iter = native_loader.NativeImageLoader(
                        paths, queue_size=self.queue_size
                    )
                except Exception:
                    native_iter = None

        img_queue: queue.Queue = queue.Queue(maxsize=self.queue_size)

        def producer():
            if native_iter is not None:
                for k, img in native_iter:
                    img_queue.put((img_idx[k], img))
            else:
                # uint8 is the canonical in-flight format (4x less
                # host->device traffic); fall back to the float API
                load_u8 = getattr(self.reader, "load_image_u8", None)
                for i in img_idx:
                    img_queue.put((i, load_u8(i) if load_u8 else self.reader.load_image(i)))
            img_queue.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()

        pending_img = None
        done = False
        k = 0  # imu cursor
        for i in img_idx:
            stamp_img = images.stamps[i]
            # emit all IMU measurements up to this image
            while k < len(imu_idx) and imu.stamps[imu_idx[k]] <= stamp_img:
                j = imu_idx[k]
                yield Measurement("imu", float(imu.stamps[j]), (imu.gyr[j], imu.acc[j]), j)
                k += 1
            if not done:
                item = img_queue.get()
                if item is None:
                    done = True
                else:
                    idx, img = item
                    assert idx == i
                    yield Measurement("image", float(stamp_img), img, i)
        # trailing IMU
        while k < len(imu_idx):
            j = imu_idx[k]
            yield Measurement("imu", float(imu.stamps[j]), (imu.gyr[j], imu.acc[j]), j)
            k += 1
