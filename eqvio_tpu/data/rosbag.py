"""ROS1 bag (v2.0) dataset reader — no ROS installation required.

Equivalent of the reference's ``RosbagDatasetReader``
(``src/dataserver/RosbagDatasetReader.cpp:44-117``) and
``HiltiDatasetReader`` (``src/dataserver/HiltiDatasetReader.cpp:21-52``).
The reference links against the ``rosbag`` C++ library; here the bag
container format itself is parsed directly (it is a simple self-describing
record stream), so bags work in any environment.

Bag format (http://wiki.ros.org/Bags/Format/2.0):

- file magic ``#ROSBAG V2.0\\n``
- a stream of records: ``<u32 header_len><header><u32 data_len><data>``
- a header is a list of fields: ``<u32 field_len>name=value`` (binary value)
- record kinds by the ``op`` field: bag header (0x03), chunk (0x05, holds
  compressed inner records), connection (0x07, topic metadata), message
  data (0x02), index (0x04) and chunk-info (0x06) records (skipped — we
  scan sequentially).

Only ``none`` and ``bz2`` chunk compression are supported (``lz4`` if the
module is importable). IMU messages (``sensor_msgs/Imu``) are deserialized
during the initial scan into flat arrays; image messages
(``sensor_msgs/Image``) are indexed by chunk location and decoded lazily so
large bags stream without holding every frame in memory — the decode runs
on the DataServer's prefetch thread, keeping the device-side pipeline fed.

Camera calibration follows the reference: an ``intrinsics.yaml`` beside the
bag (radtan, ``RosbagDatasetReader.cpp:66-96``) or, for Hilti, the
challenge's calibration yaml (equidistant fisheye + xyzw quaternion
extrinsics, ``HiltiDatasetReader.cpp:21-52``).
"""

from __future__ import annotations

import bz2
import os
import struct
from typing import NamedTuple

import numpy as np

from ..io.yaml_lite import safe_load

from .asl import CameraInfo, GroundTruth, ImageSeq, IMUSeq

_MAGIC = b"#ROSBAG V2.0\n"

OP_MSG_DATA = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX_DATA = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


def _parse_header(buf: bytes) -> dict:
    """Parse a record header into a {name: raw-bytes-value} dict."""
    fields = {}
    pos = 0
    while pos < len(buf):
        (flen,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        field = buf[pos : pos + flen]
        pos += flen
        name, _, value = field.partition(b"=")
        fields[name.decode()] = value
    return fields


def _read_record(f):
    """Read one ``<hlen><header><dlen><data-position>`` record.

    Returns (header_fields, data_offset, data_len) and leaves the file
    positioned after the record. Returns None at EOF.
    """
    raw = f.read(4)
    if len(raw) < 4:
        return None
    (hlen,) = struct.unpack("<I", raw)
    header = _parse_header(f.read(hlen))
    (dlen,) = struct.unpack("<I", f.read(4))
    data_offset = f.tell()
    f.seek(dlen, os.SEEK_CUR)
    return header, data_offset, dlen


def _iter_inner_records(buf: bytes):
    """Iterate records embedded in a (decompressed) chunk buffer."""
    pos = 0
    n = len(buf)
    while pos + 4 <= n:
        (hlen,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        header = _parse_header(buf[pos : pos + hlen])
        pos += hlen
        (dlen,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        yield header, pos, dlen
        pos += dlen


def _decompress(data: bytes, compression: str) -> bytes:
    if compression in ("none", ""):
        return data
    if compression == "bz2":
        return bz2.decompress(data)
    if compression == "lz4":
        try:
            import lz4.frame  # noqa: F401  (not in the image; gated)
        except ImportError as e:
            raise NotImplementedError(
                "bag uses lz4 chunk compression and the lz4 module is not "
                "available; re-record with bz2/none compression"
            ) from e
        return lz4.frame.decompress(data)
    raise NotImplementedError(f"unknown bag chunk compression {compression!r}")


def _u32(buf, pos):
    return struct.unpack_from("<I", buf, pos)[0], pos + 4


def _ros_string(buf, pos):
    n, pos = _u32(buf, pos)
    return buf[pos : pos + n], pos + n


def _ros_header_stamp(buf, pos=0):
    """Skip a std_msgs/Header, returning (stamp_seconds, new_pos)."""
    pos += 4  # seq
    secs, pos = _u32(buf, pos)
    nsecs, pos = _u32(buf, pos)
    _, pos = _ros_string(buf, pos)  # frame_id
    return secs + nsecs * 1e-9, pos


def _parse_imu_msg(buf: bytes):
    """Deserialize sensor_msgs/Imu → (stamp, gyr[3], acc[3]).

    Layout: Header, orientation (4 f64), orientation_cov (9 f64),
    angular_velocity (3 f64), its cov (9 f64), linear_acceleration (3 f64),
    its cov (9 f64). Mirrors ``msgToIMU`` (RosbagDatasetReader.cpp:26-33).
    """
    stamp, pos = _ros_header_stamp(buf)
    pos += (4 + 9) * 8  # orientation + its covariance
    gyr = np.frombuffer(buf, dtype="<f8", count=3, offset=pos)
    pos += (3 + 9) * 8
    acc = np.frombuffer(buf, dtype="<f8", count=3, offset=pos)
    return stamp, gyr, acc


def _parse_image_msg(buf: bytes) -> tuple[float, np.ndarray]:
    """Deserialize sensor_msgs/Image → (stamp, grayscale float32 [0,1]).

    Mirrors ``msgToImage`` + cv_bridge conversion
    (RosbagDatasetReader.cpp:35-42); colour encodings are collapsed to
    luma since the front end tracks on grayscale.
    """
    stamp, pos = _ros_header_stamp(buf)
    height, pos = _u32(buf, pos)
    width, pos = _u32(buf, pos)
    encoding, pos = _ros_string(buf, pos)
    encoding = encoding.decode().lower()
    pos += 1  # is_bigendian
    step, pos = _u32(buf, pos)
    dlen, pos = _u32(buf, pos)
    data = buf[pos : pos + dlen]

    if encoding in ("mono8", "8uc1"):
        img = np.frombuffer(data, dtype=np.uint8).reshape(height, step)[:, :width]
        img = img.astype(np.float32) / 255.0
    elif encoding in ("mono16", "16uc1"):
        img = np.frombuffer(data, dtype="<u2").reshape(height, step // 2)[:, :width]
        img = img.astype(np.float32) / 65535.0
    elif encoding in ("bgr8", "rgb8", "bgra8", "rgba8"):
        ch = 4 if encoding.endswith("a8") else 3
        img = np.frombuffer(data, dtype=np.uint8).reshape(height, step)[:, : width * ch]
        img = img.reshape(height, width, ch).astype(np.float32) / 255.0
        if encoding.startswith("bgr"):
            b, g, r = img[..., 0], img[..., 1], img[..., 2]
        else:
            r, g, b = img[..., 0], img[..., 1], img[..., 2]
        img = 0.299 * r + 0.587 * g + 0.114 * b
    else:
        raise NotImplementedError(f"image encoding {encoding!r} not supported")
    return stamp, np.ascontiguousarray(img)


class _ImageLocator(NamedTuple):
    chunk_offset: int  # file offset of the chunk's (compressed) data
    chunk_size: int  # compressed byte count
    compression: str
    inner_offset: int  # offset of the message data inside the decompressed chunk
    inner_len: int


class RosbagDatasetReader:
    """Sequential-scan bag reader exposing the common reader protocol
    (``.imu``/``.images``/``.camera``/``.groundtruth``/``load_image``).

    Reference behaviour (RosbagDatasetReader.cpp:44-64): default topics
    ``/imu0`` and ``/cam0/image_raw``; calibration from ``intrinsics.yaml``
    next to the bag when present.
    """

    def __init__(
        self,
        bag_path: str,
        camera_yaml: str | None = None,
        imu_topic: str = "/imu0",
        image_topic: str = "/cam0/image_raw",
    ):
        self.bag_path = bag_path
        self.imu_topic = imu_topic
        self.image_topic = image_topic
        self._chunk_cache: tuple[int, bytes] | None = None  # (offset, buffer)
        self.imu, self.images = self._scan()
        self.camera = self._find_camera(camera_yaml)
        # rosbag reader exposes no groundtruth (RosbagDatasetReader.h:46)
        self.groundtruth: GroundTruth | None = None

    # -- container scan ----------------------------------------------------

    def _scan(self) -> tuple[IMUSeq, ImageSeq]:
        imu_rows: list[tuple[float, np.ndarray, np.ndarray]] = []
        img_stamps: list[float] = []
        img_locs: list[_ImageLocator] = []
        topics: dict[int, str] = {}

        def handle_message(header, payload, loc):
            conn = struct.unpack("<I", header["conn"])[0]
            topic = topics.get(conn)
            if topic == self.imu_topic:
                imu_rows.append(_parse_imu_msg(payload))
            elif topic == self.image_topic:
                stamp, _ = _ros_header_stamp(payload)
                img_stamps.append(stamp)
                img_locs.append(loc)

        with open(self.bag_path, "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(
                    f"{self.bag_path}: not a ROS bag v2.0 (magic {magic!r})"
                )
            while True:
                rec = _read_record(f)
                if rec is None:
                    break
                header, data_offset, dlen = rec
                op = header.get("op", b"\x00")[0]
                if op == OP_CONNECTION:
                    conn = struct.unpack("<I", header["conn"])[0]
                    topics[conn] = header["topic"].decode()
                elif op == OP_CHUNK:
                    compression = header.get("compression", b"none").decode()
                    end = f.tell()
                    f.seek(data_offset)
                    buf = _decompress(f.read(dlen), compression)
                    f.seek(end)
                    for ih, ioff, ilen in _iter_inner_records(buf):
                        iop = ih.get("op", b"\x00")[0]
                        if iop == OP_CONNECTION:
                            conn = struct.unpack("<I", ih["conn"])[0]
                            topics[conn] = ih["topic"].decode()
                        elif iop == OP_MSG_DATA:
                            conn = struct.unpack("<I", ih["conn"])[0]
                            topic = topics.get(conn)
                            if topic == self.imu_topic:
                                imu_rows.append(
                                    _parse_imu_msg(buf[ioff : ioff + ilen])
                                )
                            elif topic == self.image_topic:
                                stamp, _ = _ros_header_stamp(buf[ioff : ioff + ilen])
                                img_stamps.append(stamp)
                                img_locs.append(
                                    _ImageLocator(
                                        data_offset, dlen, compression, ioff, ilen
                                    )
                                )
                elif op == OP_MSG_DATA:
                    # uncompressed top-level message (v2.0 writers put these
                    # in chunks, but handle the degenerate layout too)
                    end = f.tell()
                    f.seek(data_offset)
                    payload = f.read(dlen)
                    f.seek(end)
                    handle_message(
                        header,
                        payload,
                        _ImageLocator(data_offset, dlen, "none", 0, dlen),
                    )
                # ops 0x03/0x04/0x06: bag header / index / chunk info — skip

        if imu_rows:
            stamps = np.asarray([r[0] for r in imu_rows])
            gyr = np.asarray([r[1] for r in imu_rows])
            acc = np.asarray([r[2] for r in imu_rows])
        else:
            stamps = np.zeros(0)
            gyr = acc = np.zeros((0, 3))
        order = np.argsort(np.asarray(img_stamps)) if img_stamps else []
        img_seq = ImageSeq(
            np.asarray(img_stamps)[order] if len(img_stamps) else np.zeros(0),
            [img_locs[i] for i in order],
        )
        imu_order = np.argsort(stamps)
        return IMUSeq(stamps[imu_order], gyr[imu_order], acc[imu_order]), img_seq

    # -- lazy image decode ---------------------------------------------------

    def load_image(self, index: int) -> np.ndarray:
        loc: _ImageLocator = self.images.paths[index]
        if self._chunk_cache is not None and self._chunk_cache[0] == loc.chunk_offset:
            buf = self._chunk_cache[1]
        else:
            with open(self.bag_path, "rb") as f:
                f.seek(loc.chunk_offset)
                buf = _decompress(f.read(loc.chunk_size), loc.compression)
            self._chunk_cache = (loc.chunk_offset, buf)
        _, img = _parse_image_msg(buf[loc.inner_offset : loc.inner_offset + loc.inner_len])
        return img

    # -- calibration -----------------------------------------------------------

    def _find_camera(self, camera_yaml: str | None) -> CameraInfo | None:
        path = camera_yaml or os.path.join(
            os.path.dirname(os.path.abspath(self.bag_path)), "intrinsics.yaml"
        )
        if not os.path.exists(path):
            return None
        return self._read_camera(path)

    def _read_camera(self, path: str) -> CameraInfo:
        """intrinsics.yaml beside the bag (RosbagDatasetReader.cpp:66-96)."""
        with open(path) as f:
            cfg = safe_load(f)
        w, h = cfg["resolution"]
        fx, fy, cx, cy = cfg["intrinsics"][:4]
        dist = tuple(cfg.get("distortion_coefficients", ()))
        T_BS = np.eye(4)
        if "T_BS" in cfg:
            T_BS = np.asarray(cfg["T_BS"]["data"], dtype=float).reshape(4, 4)
        return CameraInfo("radtan", (fx, fy, cx, cy), dist, (int(w), int(h)), T_BS)


def _quat_xyzw_to_R(q):
    x, y, z, w = q
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


class HiltiDatasetReader(RosbagDatasetReader):
    """Hilti SLAM-challenge bags: fixed alphasense topics and the
    challenge calibration yaml (equidistant fisheye, xyzw quaternion
    extrinsics). Reference: HiltiDatasetReader.h:38-41, .cpp:21-52."""

    def __init__(self, bag_path: str, camera_yaml: str | None = None):
        super().__init__(
            bag_path,
            camera_yaml,
            imu_topic="/alphasense/imu",
            image_topic="/alphasense/cam0/image_raw",
        )

    def _read_camera(self, path: str) -> CameraInfo:
        with open(path) as f:
            cfg = safe_load(f)
        cam = cfg["sensors"]["cam0"]
        par = cam["intrinsics"]["parameters"]
        w, h = par["image_size"]
        dist = (par["k1"], par["k2"], par["k3"], par["k4"])
        ext = cam["extrinsics"]
        T_BS = np.eye(4)
        T_BS[:3, :3] = _quat_xyzw_to_R([float(v) for v in ext["quaternion"]])
        T_BS[:3, 3] = [float(v) for v in ext["translation"]]
        return CameraInfo(
            "equidistant",
            (par["fx"], par["fy"], par["cx"], par["cy"]),
            dist,
            (int(w), int(h)),
            T_BS,
        )


# -- minimal writer (testing / dataset conversion tool) -----------------------


def _field(name: str, value: bytes) -> bytes:
    body = name.encode() + b"=" + value
    return struct.pack("<I", len(body)) + body


def _record(fields: dict, data: bytes) -> bytes:
    header = b"".join(_field(k, v) for k, v in fields.items())
    return struct.pack("<I", len(header)) + header + struct.pack("<I", len(data)) + data


def _serialize_header(stamp: float, seq: int = 0, frame: bytes = b"") -> bytes:
    secs = int(stamp)
    nsecs = int(round((stamp - secs) * 1e9))
    return struct.pack("<III", seq, secs, nsecs) + struct.pack("<I", len(frame)) + frame


class BagWriter:
    """Write a minimal uncompressed v2.0 bag (IMU + mono8 images).

    Enough structure for this module's sequential reader and for
    ``rosbag reindex``-style tooling; used by the hermetic tests and as a
    conversion target for datasets without a native reader.
    """

    def __init__(self, path: str, imu_topic="/imu0", image_topic="/cam0/image_raw",
                 compression: str = "none"):
        if compression not in ("none", "bz2"):
            raise ValueError("compression must be 'none' or 'bz2'")
        self.compression = compression
        self.f = open(path, "wb")
        self.f.write(_MAGIC)
        # bag header record, padded to 4096 bytes like standard writers
        hdr = _record(
            {
                "op": bytes([OP_BAG_HEADER]),
                "index_pos": struct.pack("<Q", 0),
                "conn_count": struct.pack("<I", 2),
                "chunk_count": struct.pack("<I", 1),
            },
            b" " * 4096,
        )
        self.f.write(hdr)
        self._chunk = bytearray()
        for conn, (topic, mtype) in enumerate(
            [(imu_topic, "sensor_msgs/Imu"), (image_topic, "sensor_msgs/Image")]
        ):
            conn_header = _field("topic", topic.encode()) + _field(
                "type", mtype.encode()
            ) + _field("md5sum", b"0" * 32) + _field("message_definition", b"")
            self._chunk += _record(
                {
                    "op": bytes([OP_CONNECTION]),
                    "conn": struct.pack("<I", conn),
                    "topic": topic.encode(),
                },
                conn_header,
            )

    def _msg(self, conn: int, stamp: float, payload: bytes):
        secs = int(stamp)
        nsecs = int(round((stamp - secs) * 1e9))
        self._chunk += _record(
            {
                "op": bytes([OP_MSG_DATA]),
                "conn": struct.pack("<I", conn),
                "time": struct.pack("<II", secs, nsecs),
            },
            payload,
        )

    def write_imu(self, stamp: float, gyr, acc):
        payload = _serialize_header(stamp)
        payload += struct.pack("<4d", 0.0, 0.0, 0.0, 1.0) + struct.pack("<9d", *([0.0] * 9))
        payload += struct.pack("<3d", *np.asarray(gyr, dtype=float))
        payload += struct.pack("<9d", *([0.0] * 9))
        payload += struct.pack("<3d", *np.asarray(acc, dtype=float))
        payload += struct.pack("<9d", *([0.0] * 9))
        self._msg(0, stamp, payload)

    def write_image(self, stamp: float, img: np.ndarray):
        img8 = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
        h, w = img8.shape
        payload = _serialize_header(stamp)
        payload += struct.pack("<II", h, w)
        payload += struct.pack("<I", 5) + b"mono8"
        payload += struct.pack("<BI", 0, w)
        payload += struct.pack("<I", h * w) + img8.tobytes()
        self._msg(1, stamp, payload)

    def close(self):
        data = bytes(self._chunk)
        size = len(data)
        if self.compression == "bz2":
            data = bz2.compress(data)
        self.f.write(
            _record(
                {
                    "op": bytes([OP_CHUNK]),
                    "compression": self.compression.encode(),
                    "size": struct.pack("<I", size),
                },
                data,
            )
        )
        self.f.close()
