"""UZH-FPV dataset reader.

Equivalent of the reference ``UZHFPVDatasetReader``
(``src/dataserver/UZHFPVDatasetReader.cpp:38-139``): space-delimited
``imu.txt`` / ``left_images.txt`` with a leading index column, a kalibr
camchain yaml with equidistant (fisheye) intrinsics and inverted
``T_cam_imu`` extrinsics, and ``groundtruth.txt`` with duplicate-stamp
removal.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ..io.yaml_lite import safe_load
from .asl import CameraInfo, GroundTruth, IMUSeq, ImageSeq
from .png import load_gray_u8


class UZHFPVDatasetReader:
    def __init__(self, dataset_dir: str, camera_yaml: str | None = None):
        self.base = dataset_dir.rstrip("/") + "/"
        self.imu = self._read_imu()
        self.images = self._read_images()
        self.camera = self._read_camera(camera_yaml)
        self.groundtruth = self._read_groundtruth()

    def _read_imu(self) -> IMUSeq:
        data = np.genfromtxt(os.path.join(self.base, "imu.txt"), skip_header=1)
        # columns: id, stamp, gyr xyz, acc xyz
        return IMUSeq(data[:, 1], data[:, 2:5], data[:, 5:8])

    def _read_images(self) -> ImageSeq:
        stamps, names = [], []
        with open(os.path.join(self.base, "left_images.txt")) as f:
            next(f)
            for line in f:
                parts = line.split()
                if len(parts) >= 3:
                    stamps.append(float(parts[1]))
                    names.append(os.path.join(self.base, parts[2].strip()))
        return ImageSeq(np.asarray(stamps), names)

    def _find_camchain(self):
        # reference hard-codes ../indoor_forward_calib_snapdragon/camchain-...
        pattern = os.path.join(self.base, "..", "*calib*", "camchain-*imu.yaml")
        matches = sorted(glob.glob(pattern))
        local = sorted(glob.glob(os.path.join(self.base, "camchain-*.yaml")))
        if matches or local:
            return (matches or local)[0]
        raise FileNotFoundError(f"no kalibr camchain found near {self.base}")

    def _read_camera(self, camera_yaml) -> CameraInfo:
        path = camera_yaml or self._find_camchain()
        with open(path) as f:
            cfg = safe_load(f)["cam0"]
        fu, fv, cu, cv = cfg["intrinsics"]
        dist = tuple(cfg["distortion_coeffs"])
        w, h = cfg["resolution"]
        T_cam_imu = np.asarray(cfg["T_cam_imu"], dtype=float).reshape(4, 4)
        # reported as IMU w.r.t. camera -> invert (UZHFPVDatasetReader.cpp:115)
        T_BS = np.linalg.inv(T_cam_imu)
        return CameraInfo("equidistant", (fu, fv, cu, cv), dist, (int(w), int(h)), T_BS)

    def _read_groundtruth(self) -> GroundTruth | None:
        path = os.path.join(self.base, "groundtruth.txt")
        if not os.path.exists(path):
            return None
        data = np.genfromtxt(path, skip_header=1)
        # columns: id, stamp, px py pz, qx qy qz qw (TUM order) — the
        # reference parses via CSVLine>>SE3 which expects x then (w,x,y,z);
        # UZH-FPV groundtruth.txt is "id timestamp tx ty tz qx qy qz qw"
        stamps = data[:, 1]
        keep = np.concatenate([[True], np.diff(stamps) > 1e-8])
        data = data[keep]
        stamps = stamps[keep]
        pos = data[:, 2:5]
        qxyzw = data[:, 5:9]
        quat = np.stack([qxyzw[:, 3], qxyzw[:, 0], qxyzw[:, 1], qxyzw[:, 2]], axis=-1)
        return GroundTruth(stamps, pos, quat, None)

    def load_image(self, index: int) -> np.ndarray:
        return self.load_image_u8(index).astype(np.float32) / 255.0

    def load_image_u8(self, index: int) -> np.ndarray:
        """Decode image ``index`` to grayscale uint8 (canonical in-flight
        format: 4x less host->device traffic than f32)."""
        return load_gray_u8(self.images.paths[index])
