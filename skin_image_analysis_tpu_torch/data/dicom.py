"""DICOM ingest without pydicom (a copy of the JAX package's built-in
``data.dicom`` parser).

Enough of PS3.10/PS3.5 for the skin-image archives:

- implicit and explicit VR little endian native pixel data (8/16/32-bit
  mono, RGB), and the deflated explicit form;
- encapsulated JPEG transfer syntaxes (1.2.840.10008.1.2.4.5x/7x): the
  PixelData fragments are handed to PIL or cv2, so this form needs one of
  them, and without either raises an ImportError that names them;
- MONOCHROME1 inversion, rescale slope/intercept, planar configuration 1,
  and the min-max stretch to uint8.

The JAX package reads through pydicom first where it is installed; the
port always uses this parser.
"""

from __future__ import annotations

import io
import os
import struct
from typing import Sequence

import numpy as np

from skin_image_analysis_tpu_torch.data.loader import rescale_image

_IMPLICIT_LE = "1.2.840.10008.1.2"
_EXPLICIT_LE = "1.2.840.10008.1.2.1"
_EXPLICIT_BE = "1.2.840.10008.1.2.2"
_DEFLATED_LE = "1.2.840.10008.1.2.1.99"
# encapsulated JPEG-family syntaxes PIL can decode
_JPEG_SYNTAXES = {
    "1.2.840.10008.1.2.4.50",  # JPEG baseline (process 1) — ISIC-2020
    "1.2.840.10008.1.2.4.51",  # JPEG extended (process 2 & 4)
    "1.2.840.10008.1.2.4.57",  # JPEG lossless
    "1.2.840.10008.1.2.4.70",  # JPEG lossless SV1
}

# tags we care about: (group, element) -> name
_TAGS = {
    (0x0028, 0x0002): "samples_per_pixel",
    (0x0028, 0x0004): "photometric",
    (0x0028, 0x0006): "planar_config",
    (0x0028, 0x0008): "number_of_frames",
    (0x0028, 0x0010): "rows",
    (0x0028, 0x0011): "cols",
    (0x0028, 0x0100): "bits_allocated",
    (0x0028, 0x0103): "pixel_representation",
    (0x0028, 0x1052): "rescale_intercept",
    (0x0028, 0x1053): "rescale_slope",
    (0x7FE0, 0x0010): "pixel_data",
}

# explicit-VR codes whose length field is 4 bytes after 2 reserved bytes
_LONG_VRS = {b"OB", b"OW", b"OF", b"OL", b"OD", b"SQ", b"UC", b"UR",
             b"UT", b"UN"}


class DicomParseError(ValueError):
    pass


class _Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def u16(self) -> int:
        try:
            v = struct.unpack_from("<H", self.data, self.pos)[0]
        except struct.error as e:  # truncated file: clean parse error
            raise DicomParseError(f"truncated at offset {self.pos}") from e
        self.pos += 2
        return v

    def u32(self) -> int:
        try:
            v = struct.unpack_from("<I", self.data, self.pos)[0]
        except struct.error as e:
            raise DicomParseError(f"truncated at offset {self.pos}") from e
        self.pos += 4
        return v

    def take(self, n: int) -> bytes:
        v = self.data[self.pos : self.pos + n]
        if len(v) < n:
            raise DicomParseError(
                f"element at offset {self.pos} claims {n} bytes, "
                f"{len(v)} remain")
        self.pos += n
        return v

    def eof(self) -> bool:
        return self.pos >= len(self.data)


def _read_element(r: _Reader, explicit: bool):
    """Returns (group, element, value_bytes_or_None, undefined_length,
    vr). Delimiter items (group FFFE) never carry a VR."""
    group = r.u16()
    elem = r.u16()
    if group == 0xFFFE:  # item / delimiter — always implicit structure
        length = r.u32()
        return group, elem, None, length == 0xFFFFFFFF, b"", length
    if explicit:
        vr = r.take(2)
        if vr in _LONG_VRS:
            r.take(2)  # reserved
            length = r.u32()
        else:
            length = r.u16()
    else:
        vr = b""
        length = r.u32()
    if length == 0xFFFFFFFF:
        return group, elem, None, True, vr, length
    return group, elem, r.take(length), False, vr, length


def _skip_sequence(r: _Reader, explicit: bool) -> None:
    """Skip an undefined-length SQ: items until SequenceDelimitationItem."""
    while not r.eof():
        group, elem, value, undef, _vr, length = _read_element(r, explicit)
        if (group, elem) == (0xFFFE, 0xE0DD):  # sequence delimiter
            return
        if (group, elem) == (0xFFFE, 0xE000):  # item
            if undef:
                _skip_item(r, explicit)
            else:
                r.take(length) if value is None else None
        else:
            if undef:
                _skip_sequence(r, explicit)
    raise DicomParseError("unterminated sequence")


def _skip_item(r: _Reader, explicit: bool) -> None:
    """Skip an undefined-length item: elements until ItemDelimitationItem."""
    while not r.eof():
        group, elem, value, undef, _vr, _length = _read_element(r, explicit)
        if (group, elem) == (0xFFFE, 0xE00D):  # item delimiter
            return
        if undef:
            _skip_sequence(r, explicit)
    raise DicomParseError("unterminated item")


def _read_fragments(r: _Reader) -> list[bytes]:
    """Encapsulated PixelData: basic offset table item + fragment items,
    ending with a sequence delimiter (PS3.5 A.4)."""
    frags: list[bytes] = []
    first = True
    while not r.eof():
        group = r.u16()
        elem = r.u16()
        length = r.u32()
        if (group, elem) == (0xFFFE, 0xE0DD):
            return frags
        if (group, elem) != (0xFFFE, 0xE000):
            raise DicomParseError("malformed encapsulated pixel data")
        data = r.take(length)
        if first:
            first = False  # basic offset table (may be empty) — discard
            continue
        frags.append(data)
    raise DicomParseError("unterminated encapsulated pixel data")


# tags whose value is a little-endian unsigned short (VR=US); the rest of
# the tags we read are decimal/code strings (DS/IS/CS)
_US_TAGS = {"samples_per_pixel", "planar_config", "rows", "cols",
            "bits_allocated", "pixel_representation"}


def _scalar(name: str, value: bytes):
    """Decode the small set of value types the needed tags use — driven by
    the tag (implicit VR carries no VR bytes, so length heuristics are
    unreliable: an IS string can be 2 bytes long too)."""
    if name in _US_TAGS:
        if len(value) < 2:
            raise DicomParseError(f"truncated US value for {name}")
        return struct.unpack("<H", value[:2])[0]
    return value.decode("ascii", "ignore").strip("\x00 ").strip()


def parse_dicom(data: bytes) -> dict:
    """Parse one DICOM file's bytes into {tag_name: value, 'pixel_data':
    bytes | list[bytes], 'transfer_syntax': str, 'encapsulated': bool}."""
    pos = 0
    if len(data) > 132 and data[128:132] == b"DICM":
        pos = 132
    r = _Reader(data, pos)

    # --- file meta (group 0002): always explicit VR LE ---
    syntax = _EXPLICIT_LE
    meta_end = None
    while not r.eof():
        mark = r.pos
        if r.pos + 2 > len(r.data):
            raise DicomParseError(f"truncated at offset {r.pos}")
        group = struct.unpack_from("<H", r.data, r.pos)[0]
        if group != 0x0002:
            r.pos = mark
            break
        g, e, value, undef, vr, _length = _read_element(r, explicit=True)
        if (g, e) == (0x0002, 0x0000) and value is not None and len(value) >= 4:
            meta_end = r.pos + struct.unpack("<I", value[:4])[0]
        if (g, e) == (0x0002, 0x0010) and value is not None:
            syntax = value.decode("ascii").strip("\x00 ")
        if meta_end is not None and r.pos >= meta_end:
            break
    if pos == 0 and r.pos == 0:
        # No preamble and no meta group: a raw dataset. Sniff the VR —
        # explicit-VR elements carry two uppercase ASCII letters at
        # bytes [4:6]; implicit-VR has a 4-byte length there.
        probe = r.data[4:6]
        if probe.isalpha() and probe.isupper():
            syntax = _EXPLICIT_LE
        else:
            syntax = _IMPLICIT_LE

    if syntax == _EXPLICIT_BE:
        raise DicomParseError("big-endian DICOM is not supported")
    if syntax == _DEFLATED_LE:
        import zlib

        try:
            rest = zlib.decompress(r.data[r.pos:], -15)
        except zlib.error as e:
            raise DicomParseError(f"corrupt deflated dataset: {e}") from e
        r = _Reader(rest, 0)
        syntax = _EXPLICIT_LE

    explicit = syntax != _IMPLICIT_LE
    encapsulated = syntax in _JPEG_SYNTAXES or (
        syntax.startswith("1.2.840.10008.1.2.4")
        or syntax.startswith("1.2.840.10008.1.2.5")
    )

    out: dict = {"transfer_syntax": syntax, "encapsulated": encapsulated}
    while not r.eof():
        group, elem, value, undef, vr, length = _read_element(r, explicit)
        name = _TAGS.get((group, elem))
        if (group, elem) == (0x7FE0, 0x0010):
            if undef:
                out["pixel_data"] = _read_fragments(r)
            else:
                out["pixel_data"] = value
            break  # pixel data is last in these archives
        if undef:  # undefined-length SQ (or UN) — skip structurally
            _skip_sequence(r, explicit)
            continue
        if name and value is not None:
            out[name] = _scalar(name, value)
    return out


def _decode_jpeg_bytes(blob: bytes) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError:
        try:
            import cv2
        except ImportError:
            raise ImportError(
                "a JPEG-encapsulated DICOM needs PIL (pillow) or cv2 "
                "(opencv-python) to decode, and neither is installed; "
                "decode the cohort on a host that has one, or store it as "
                "native-pixel DICOM") from None

        arr = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
        if arr is None:
            raise DicomParseError("undecodable JPEG fragment")
        return arr[:, :, ::-1]
    try:
        with Image.open(io.BytesIO(blob)) as im:
            return np.asarray(im.convert("RGB"), dtype=np.uint8)
    except Exception as e:
        # PIL's errors for a corrupt stream become the parser's error type
        raise DicomParseError(f"undecodable encapsulated frame: {e}") from e


def _to_uint8_rgb(ds: dict) -> np.ndarray:
    """Pixel bytes → uint8 RGB HWC, applying photometric/rescale rules."""
    if ds["encapsulated"]:
        frags = ds["pixel_data"]
        if not frags:
            raise DicomParseError("no pixel-data fragments")
        # single-frame dermoscopy images: fragments concatenate to one frame
        return _decode_jpeg_bytes(b"".join(frags))

    if "rows" not in ds or "cols" not in ds:
        raise DicomParseError("missing Rows/Columns for native pixel data")
    rows, cols = int(ds["rows"]), int(ds["cols"])
    if rows <= 0 or cols <= 0:
        raise DicomParseError(f"bad image dimensions {rows}x{cols}")
    samples = int(ds.get("samples_per_pixel", 1))
    bits = int(ds.get("bits_allocated", 8))
    if bits not in (8, 16, 32) or samples not in (1, 3):
        raise DicomParseError(
            f"unsupported bits_allocated={bits} samples={samples}")
    signed = int(ds.get("pixel_representation", 0)) == 1
    dtype = {8: np.uint8, 16: np.uint16, 32: np.uint32}[bits]
    if signed:
        dtype = {8: np.int8, 16: np.int16, 32: np.int32}[bits]
    n_frames = int(ds.get("number_of_frames", 1) or 1)
    arr = np.frombuffer(ds["pixel_data"], dtype=dtype)
    need = rows * cols * samples * n_frames
    arr = arr[:need].reshape(n_frames, rows, cols, samples)[0]
    if samples == 3 and int(ds.get("planar_config", 0)) == 1:
        arr = np.frombuffer(ds["pixel_data"], dtype=dtype)[
            : rows * cols * 3
        ].reshape(3, rows, cols).transpose(1, 2, 0)

    arr = arr.astype(np.float32)
    slope = float(ds.get("rescale_slope", 1.0) or 1.0)
    intercept = float(ds.get("rescale_intercept", 0.0) or 0.0)
    arr = arr * slope + intercept
    photometric = str(ds.get("photometric", "MONOCHROME2")).upper()
    if photometric == "MONOCHROME1":
        arr = arr.max() - arr  # inverted grayscale
    lo, hi = float(arr.min()), float(arr.max())
    if hi > lo:
        arr = (arr - lo) / (hi - lo)
    elif hi > 0:
        arr = arr / hi
    arr = (arr * 255.0 + 0.5).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    return arr[..., :3]


def read_dicom_image(path: str) -> np.ndarray:
    """One DICOM file -> uint8 RGB HWC array."""
    with open(path, "rb") as f:
        data = f.read()
    ds = parse_dicom(data)
    if "pixel_data" not in ds:
        raise DicomParseError(f"{path}: no PixelData element")
    return _to_uint8_rgb(ds)


class DicomFolder:
    """The ``*.dcm`` files of a folder, sorted by name; ``decode(i)`` is
    the i-th as a uint8 RGB ``[S, S, 3]`` frame at ``canonical_size``
    (the resize needs cv2 or PIL, unless the frame is at that size)."""

    def __init__(self, root: str, canonical_size: int = 224):
        self.root = root
        self.size = canonical_size
        self.names: Sequence[str] = sorted(
            n for n in os.listdir(root) if n.lower().endswith(".dcm"))

    def __len__(self) -> int:
        return len(self.names)

    def decode(self, idx: int) -> np.ndarray:
        img = read_dicom_image(os.path.join(self.root, self.names[idx]))
        return rescale_image(img, (self.size, self.size))
