"""TensorBoard event files, written and read without tensorboardX or protobuf.

The port's stand-in for what fastenhancer_tpu/utils/summarize.py writes
through tensorboardX's `SummaryWriter`, and nothing more: scalars,
histograms (tensorboardX's default "tensorflow" buckets), HWC uint8 images
(PNG-encoded with zlib) and mono PCM16 audio. The card's machine has none
of tensorboardX, protobuf or PIL, so the file format is written by hand:

  * a file `events.out.tfevents.<time>.<host>` in the log directory, as
    tensorboardX names it, whose first event is
    `Event{wall_time, file_version: "brain.Event:2"}`;
  * TFRecord framing: uint64 length, masked CRC-32C of the length, the
    payload, masked CRC-32C of the payload (little-endian);
  * each payload a protobuf `Event{wall_time=1, step=2, summary=5}` with
    `Summary{value=1}` and `Summary.Value{tag=1, simple_value=2, image=4,
    histo=5, audio=6}` (tensorboard/compat/proto/{event,summary}.proto),
    encoded on the wire by hand.

`read_events` parses such a file back, checking every record's CRCs, for
checks on a machine without tensorboard. Imports only the standard library
and numpy.
"""
from __future__ import annotations

import io
import os
import re
import socket
import struct
import time
import typing as tp
import wave
import zlib

import numpy as np

# -- CRC-32C (Castagnoli), reflected polynomial 0x82F63B78 --------------------


def _crc_table() -> np.ndarray:
    c = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        c = np.where(c & 1, (c >> 1) ^ np.uint32(0x82F63B78), c >> 1)
    return c.astype(np.uint32)


_TABLE = _crc_table()
_TABLE_LIST = _TABLE.tolist()


def _crc_update(reg: int, data: bytes) -> int:
    """The CRC register after `data`, byte by byte (no pre/post xor)."""
    t = _TABLE_LIST
    for b in data:
        reg = t[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg


def _crc_lanes(data: bytes, lane: int) -> int:
    """The register update over a long `data` from register 0xFFFFFFFF,
    computed as M independent lanes of `lane` bytes in numpy, then chained.
    The update over L bytes is affine: reg -> A^L reg ^ g(bytes); the loop
    runs the lanes (from register 0, giving g) and 32 extra lanes (unit
    registers over zero bytes, giving A^L's columns) together."""
    m = len(data) // lane
    lanes = np.frombuffer(data, np.uint8, m * lane).reshape(m, lane)
    regs = np.zeros(m + 32, np.uint32)
    regs[m:] = np.uint32(1) << np.arange(32, dtype=np.uint32)
    byte = np.zeros(m + 32, np.uint32)
    for p in range(lane):
        byte[:m] = lanes[:, p]
        regs = _TABLE[(regs ^ byte) & 0xFF] ^ (regs >> 8)
    cols = regs[m:]
    # A^L applied a byte of the register at a time: 4 tables of 256
    v = np.arange(256, dtype=np.uint32)
    shift = []
    for k in range(4):
        t = np.zeros(256, np.uint32)
        for bit in range(8):
            t ^= np.where((v >> bit) & 1, cols[8 * k + bit], np.uint32(0))
        shift.append(t.tolist())
    t0, t1, t2, t3 = shift
    reg = 0xFFFFFFFF
    for g in regs[:m].tolist():
        reg = (t0[reg & 0xFF] ^ t1[(reg >> 8) & 0xFF] ^ t2[(reg >> 16) & 0xFF]
               ^ t3[reg >> 24] ^ g)
    return _crc_update(reg, data[m * lane:])


def crc32c(data: bytes) -> int:
    """CRC-32C of `data` (check value: crc32c(b"123456789") = 0xE3069283)."""
    data = bytes(data)
    if len(data) < 4096:
        reg = _crc_update(0xFFFFFFFF, data)
    else:
        reg = _crc_lanes(data, max(64, int(len(data) ** 0.5)))
    return reg ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: ((crc >> 15) | (crc << 17)) + 0xa282ead8."""
    x = crc32c(data)
    return (((x >> 15) | (x << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- protobuf wire format -----------------------------------------------------

def _varint(n: int) -> bytes:
    n &= 0xFFFFFFFFFFFFFFFF  # int64 negatives as two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _int(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(int(v))


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", float(v))


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", float(v))


def _bytes(field: int, b: bytes) -> bytes:
    return _key(field, 2) + _varint(len(b)) + b


def _str(field: int, s: str) -> bytes:
    return _bytes(field, s.encode())


def _doubles(field: int, vals: tp.Sequence[float]) -> bytes:
    return _bytes(field, np.asarray(vals, "<f8").tobytes())  # packed


def _fields(buf: bytes) -> tp.Dict[int, tp.List[tp.Any]]:
    """{field number: [values]} of one message: ints for varints, bytes for
    length-delimited and fixed-width fields."""
    out: tp.Dict[int, tp.List[tp.Any]] = {}
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            v, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"unsupported wire type {wire}")
        out.setdefault(field, []).append(v)
    return out


def _read_varint(buf: bytes, i: int) -> tp.Tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, i


# -- payloads -----------------------------------------------------------------

_INVALID_TAG_CHARACTERS = re.compile(r"[^-/\w\.]")


def _clean_tag(name: str) -> str:
    """tensorboardX's tag cleaning: illegal characters to "_", no leading
    slash (scalars, histograms and images; audio tags pass as given)."""
    return _INVALID_TAG_CHARACTERS.sub("_", name).lstrip("/")


def _default_bins() -> tp.List[float]:
    """tensorboardX's (and TensorFlow's) default histogram bucket edges:
    +-1e-12 * 1.1^k up to 1e20, and 0."""
    v, buckets = 1e-12, []
    while v < 1e20:
        buckets.append(v)
        v *= 1.1
    return [-b for b in buckets[::-1]] + [0] + buckets


DEFAULT_BINS = _default_bins()


def histogram_proto(values: np.ndarray) -> bytes:
    """HistogramProto of `values` as tensorboardX's `make_histogram` builds
    it over DEFAULT_BINS: float64 statistics, the empty edge buckets
    trimmed to one empty bucket on the left."""
    values = np.asarray(values).reshape(-1).astype(float)
    if values.size == 0:
        raise ValueError("the histogram has no value")
    counts, limits = np.histogram(values, bins=DEFAULT_BINS)
    cum = np.cumsum(np.greater(counts, 0))
    start, end = np.searchsorted(cum, [0, cum[-1] - 1], side="right")
    start, end = int(start), int(end) + 1
    counts = (counts[start - 1:end] if start > 0
              else np.concatenate([[0], counts[:end]]))
    limits = limits[start:end + 1]
    return (_double(1, values.min()) + _double(2, values.max())
            + _double(3, len(values)) + _double(4, values.sum())
            + _double(5, values.dot(values)) + _doubles(6, limits)
            + _doubles(7, counts))


def encode_png(img: np.ndarray) -> bytes:
    """HWC uint8 (C = 1, 3 or 4) -> PNG bytes (8-bit, no filter, zlib)."""
    h, w, c = img.shape
    color = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img, np.uint8).reshape(h, -1)],
                          axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """The inverse of encode_png (no-filter PNGs only) -> HWC uint8."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    i, idat, hdr = 8, b"", None
    while i < len(data):
        n, kind = struct.unpack(">I4s", data[i:i + 8])
        body = data[i + 8:i + 8 + n]
        if struct.unpack(">I", data[i + 8 + n:i + 12 + n])[0] != (
                zlib.crc32(kind + body) & 0xFFFFFFFF):
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        i += 12 + n
    w, h, _, color = hdr[:4]
    c = {0: 1, 2: 3, 6: 4}[color]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    if rows[:, 0].any():
        raise ValueError("filtered PNG rows are not supported")
    return rows[:, 1:].reshape(h, w, c)


def wav_pcm16_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    """Mono PCM16 RIFF bytes from the standard library's `wave`."""
    buf = io.BytesIO()
    pcm = np.clip(np.asarray(wav, np.float32) * 32768.0, -32768,
                  32767).astype("<i2")
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())
    return buf.getvalue()


# -- the writer ---------------------------------------------------------------

class EventWriter:
    """Appends summaries to one event file in `logdir` (created), as
    tensorboardX's SummaryWriter(logdir) does for the calls below."""

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{str(time.time())[:10]}."
                    f"{socket.gethostname()}{filename_suffix}")
        self._f: tp.Optional[tp.BinaryIO] = open(self.path, "ab")
        self._write(_double(1, time.time()) + _str(3, "brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        if self._f is None:
            raise ValueError(f"{self.path}: the writer is closed")
        head = struct.pack("<Q", len(payload))
        self._f.write(head + struct.pack("<I", masked_crc32c(head)) + payload
                      + struct.pack("<I", masked_crc32c(payload)))

    def _add_value(self, value: bytes, step: int,
                   walltime: tp.Optional[float]) -> None:
        summary = _bytes(1, value)
        self._write(_double(1, time.time() if walltime is None else walltime)
                    + _int(2, step) + _bytes(5, summary))

    def add_scalar(self, tag: str, value: float, step: int,
                   walltime: tp.Optional[float] = None) -> None:
        v = float(np.asarray(value, np.float64).squeeze())
        self._add_value(_str(1, _clean_tag(tag)) + _float(2, v), step,
                        walltime)

    def add_histogram(self, tag: str, values: np.ndarray, step: int,
                      walltime: tp.Optional[float] = None) -> None:
        self._add_value(_str(1, _clean_tag(tag))
                        + _bytes(5, histogram_proto(values)), step, walltime)

    def add_image(self, tag: str, img: np.ndarray, step: int,
                  walltime: tp.Optional[float] = None) -> None:
        """`img`: HWC uint8, C = 1, 3 or 4."""
        img = np.asarray(img)
        if img.dtype != np.uint8 or img.ndim != 3:
            raise ValueError(f"add_image takes HWC uint8, not {img.dtype} "
                             f"{img.shape}")
        h, w, c = img.shape
        image = (_int(1, h) + _int(2, w) + _int(3, c)
                 + _bytes(4, encode_png(img)))
        self._add_value(_str(1, _clean_tag(tag)) + _bytes(4, image), step,
                        walltime)

    def add_audio(self, tag: str, wav: np.ndarray, step: int,
                  sample_rate: int, walltime: tp.Optional[float] = None
                  ) -> None:
        """Mono float audio as a PCM16 WAV, clipped to [-1, 1)."""
        wav = np.asarray(wav, np.float32).reshape(-1)
        audio = (_float(1, sample_rate) + _int(2, 1) + _int(3, len(wav))
                 + _bytes(4, wav_pcm16_bytes(wav, sample_rate))
                 + _str(5, "audio/wav"))
        self._add_value(_str(1, tag) + _bytes(6, audio), step, walltime)

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


# -- the reader ---------------------------------------------------------------

def _f64(b: bytes) -> float:
    return struct.unpack("<d", b)[0]


def _value(v: tp.Dict[int, tp.List[tp.Any]]) -> tp.Tuple[str, tp.Any]:
    if 2 in v:
        return "simple_value", struct.unpack("<f", v[2][0])[0]
    if 5 in v:
        h = _fields(v[5][0])
        return "histo", {
            "min": _f64(h[1][0]), "max": _f64(h[2][0]),
            "num": _f64(h[3][0]), "sum": _f64(h[4][0]),
            "sum_squares": _f64(h[5][0]),
            "bucket_limit": np.frombuffer(h[6][0], "<f8").tolist(),
            "bucket": np.frombuffer(h[7][0], "<f8").tolist()}
    if 4 in v:
        im = _fields(v[4][0])
        return "image", {"height": im[1][0], "width": im[2][0],
                         "colorspace": im[3][0],
                         "encoded_image_string": im[4][0]}
    if 6 in v:
        a = _fields(v[6][0])
        return "audio", {"sample_rate": struct.unpack("<f", a[1][0])[0],
                         "num_channels": a[2][0],
                         "length_frames": a[3][0],
                         "encoded_audio_string": a[4][0],
                         "content_type": a[5][0].decode()}
    raise ValueError(f"unsupported summary value fields {sorted(v)}")


def read_events(path: str) -> tp.List[tp.Dict[str, tp.Any]]:
    """Every event of an event file, each record's two CRCs checked:
    [{"wall_time", "step", "file_version" (or None), "values": [(tag,
    kind, value)]}], kind one of simple_value, histo, image, audio."""
    with open(path, "rb") as f:
        data = f.read()
    events, i = [], 0
    while i < len(data):
        head = data[i:i + 8]
        (n,) = struct.unpack("<Q", head)
        (crc,) = struct.unpack("<I", data[i + 8:i + 12])
        if crc != masked_crc32c(head):
            raise ValueError(f"{path}: bad length CRC at byte {i}")
        payload = data[i + 12:i + 12 + n]
        (crc,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if len(payload) != n or crc != masked_crc32c(payload):
            raise ValueError(f"{path}: bad payload CRC at byte {i}")
        i += 16 + n
        ev = _fields(payload)
        values = []
        for raw in (_fields(ev[5][0]).get(1, []) if 5 in ev else []):
            v = _fields(raw)
            values.append((v[1][0].decode(), *_value(v)))
        events.append({"wall_time": _f64(ev[1][0]),
                       "step": ev.get(2, [0])[0],
                       "file_version": (ev[3][0].decode() if 3 in ev
                                        else None),
                       "values": values})
    return events


__all__ = ["EventWriter", "read_events", "crc32c", "masked_crc32c",
           "histogram_proto", "encode_png", "decode_png", "wav_pcm16_bytes",
           "DEFAULT_BINS"]
