"""Dependency-free TFRecord + tf.train.Example reader/writer.

Counterpart of ``hyper_graph_nets_tpu/data/tfrecord.py``: the framing
(length + masked CRC32C) and the minimal protobuf subset of the DeepMind
MeshGraphNets datasets, whose Example features are single-element
bytes_lists of raw array bytes, decoded per ``meta.json``.  The same
trajectories give the same bytes as the JAX package's writer, so either
package reads the other's files.

CRC32C runs in C (``csrc/crc32c.c``, built by the host compiler at first
use); on a machine with no C compiler it falls back to a numpy loop of about
1 MB/s and logs so.  :func:`crc32c_backend` says which one runs.
"""
from __future__ import annotations

import ctypes
import logging
import os
import struct
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from hyper_graph_nets_tpu_torch.ops import build

log = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), with the TFRecord masking.
# ---------------------------------------------------------------------------

_CRC_TABLE = np.zeros(256, np.uint32)
for _i in range(256):
    _c = np.uint32(_i)
    for _ in range(8):
        _c = np.uint32(0x82F63B78) ^ (_c >> np.uint32(1)) if _c & np.uint32(1) else _c >> np.uint32(1)
    _CRC_TABLE[_i] = _c

_native = None  # the loaded library, False once the build failed, None before the first call
_native_lock = threading.Lock()


def _native_crc():
    global _native
    with _native_lock:
        if _native is None:
            try:
                lib = build.load_host(build.source_path("crc32c.c"))
            except (RuntimeError, OSError) as exc:
                log.warning("CRC32C: C build failed (%s); using the numpy loop (about 1 MB/s)", exc)
                _native = False
            else:
                lib.hgn_crc32c_init.restype = None
                lib.hgn_crc32c_init.argtypes = []
                lib.hgn_crc32c.restype = ctypes.c_uint32
                lib.hgn_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
                lib.hgn_crc32c_init()
                log.info("CRC32C: C (%s)", lib._name)
                _native = lib
        return _native or None


def crc32c_backend() -> str:
    """``"c"`` or ``"numpy"``: the CRC32C this process runs."""
    return "c" if _native_crc() is not None else "numpy"


def crc32c_numpy(data: bytes) -> int:
    """The numpy loop (the fallback without a C compiler)."""
    crc = np.uint32(0xFFFFFFFF)
    table = _CRC_TABLE
    for b in np.frombuffer(data, np.uint8):
        crc = table[(crc ^ b) & np.uint32(0xFF)] ^ (crc >> np.uint32(8))
    return int(crc ^ np.uint32(0xFFFFFFFF))


def crc32c(data: bytes) -> int:
    lib = _native_crc()
    if lib is None:
        return crc32c_numpy(data)
    return int(lib.hgn_crc32c(data, len(data)))


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire-format codec for tf.train.Example.
#
# Example          = { features: Features = 1 }
# Features         = { feature: map<string, Feature> = 1 }
# map entry        = { key: string = 1, value: Feature = 2 }
# Feature          = { bytes_list: BytesList = 1, float_list = 2, int64_list = 3 }
# BytesList        = { value: repeated bytes = 1 }
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _iter_fields(buf: bytes) -> Iterator[tuple[int, int, bytes | int]]:
    """Yield (field_number, wire_type, payload) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 0x7
        if wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos : pos + ln]
            pos += ln
        elif wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 5:  # 32-bit
            yield field, wire, buf[pos : pos + 4]
            pos += 4
        elif wire == 1:  # 64-bit
            yield field, wire, buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def parse_example(buf: bytes) -> Dict[str, bytes]:
    """Parse an Example proto into {feature name: first bytes_list element}."""
    out: Dict[str, bytes] = {}
    for field, _, features_buf in _iter_fields(buf):
        if field != 1:
            continue
        for f2, _, entry in _iter_fields(features_buf):  # Features.feature map
            if f2 != 1:
                continue
            key: Optional[str] = None
            feature_buf: Optional[bytes] = None
            for f3, _, payload in _iter_fields(entry):
                if f3 == 1:
                    key = payload.decode("utf-8")
                elif f3 == 2:
                    feature_buf = payload
            if key is None or feature_buf is None:
                continue
            for f4, _, lst in _iter_fields(feature_buf):  # Feature.bytes_list
                if f4 != 1:
                    continue
                for f5, _, raw in _iter_fields(lst):  # BytesList.value
                    if f5 == 1:
                        out[key] = raw
                        break
    return out


def build_example(features: Dict[str, bytes]) -> bytes:
    """Serialize {name: raw bytes} into an Example proto."""

    def ld(field: int, payload: bytes) -> bytes:
        return _write_varint((field << 3) | 2) + _write_varint(len(payload)) + payload

    entries = b""
    for key, raw in features.items():
        feature = ld(1, ld(1, raw))
        entries += ld(1, ld(1, key.encode("utf-8")) + ld(2, feature))
    return ld(1, entries)


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------


def read_records(path: str) -> Iterator[bytes]:
    """Iterate raw record payloads from a TFRecord file (length CRC checked;
    the data CRC is skipped for speed, as the JAX package does)."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:])
            if _masked_crc(header[:8]) != len_crc:
                raise ValueError(f"corrupt TFRecord length CRC in {path}")
            payload = f.read(length)
            f.read(4)
            yield payload


def write_records(path: str, payloads: Iterator[bytes]) -> None:
    """Write records atomically (a temporary file, then ``os.replace``): an
    interrupted writer never leaves a truncated file at ``path``."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        for payload in payloads:
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(payload)
            f.write(struct.pack("<I", _masked_crc(payload)))
    os.replace(tmp, path)


def write_trajectories(path: str, trajectories: List[Dict[str, np.ndarray]]) -> None:
    """Write trajectories (dict of arrays) as Example records of raw bytes;
    the static features (``cells``, ``mesh_pos``, ``node_type``) once."""

    def payloads():
        for traj in trajectories:
            feats = {}
            for key, val in traj.items():
                arr = np.ascontiguousarray(val)
                if key in ("cells", "mesh_pos", "node_type"):
                    arr = arr[:1]
                feats[key] = arr.tobytes()
            yield build_example(feats)

    write_records(path, payloads())


def read_trajectories(path: str, meta: dict) -> Iterator[Dict[str, np.ndarray]]:
    """Decode Example records into trajectory dicts of writable arrays per a
    meta.json schema; static features are tiled over ``trajectory_length``."""
    features = meta["features"]
    T = meta["trajectory_length"]
    for payload in read_records(path):
        raw = parse_example(payload)
        traj = {}
        for key, spec in features.items():
            if key not in raw:
                continue
            # a writable copy: torch warns on (and must not write into) the
            # read-only buffer
            arr = np.frombuffer(raw[key], dtype=np.dtype(spec["dtype"])).reshape(spec["shape"]).copy()
            if spec["type"] == "static":
                arr = np.tile(arr, (T, 1, 1))
            elif spec["type"] not in ("dynamic", "dynamic_varlen"):
                raise ValueError(f"invalid feature type {spec['type']}")
            traj[key] = arr
        yield traj
