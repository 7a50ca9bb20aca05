"""Image output, comparison, and render checkpointing.

The reference is display-only (no image export of any kind,
SURVEY.md §5); this module adds PNG export, RMSE gates against the
oracle, and resumable accumulation checkpoints — all with zero external
dependencies (hand-rolled PNG via zlib).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def display_transform(accumulated: np.ndarray, samples: int,
                      tonemap: str = "gamma2") -> np.ndarray:
    """Average + tone map.

    ``gamma2`` is the reference's display pass
    (display_shader.wgsl:50-53: sqrt of the mean).  ``reinhard``
    (x/(1+x)) and ``aces`` (Narkowicz's RTT+ODT fit) are
    beyond-reference options for HDR-ish scenes — both are followed by
    the same gamma-2 encode so mid-gray placement stays comparable.
    """
    avg = np.asarray(accumulated, np.float32) / max(1, samples)
    avg = np.clip(avg, 0.0, None)
    if tonemap == "reinhard":
        avg = avg / (1.0 + avg)
    elif tonemap == "aces":
        avg = np.clip((avg * (2.51 * avg + 0.03))
                      / (avg * (2.43 * avg + 0.59) + 0.14), 0.0, 1.0)
    elif tonemap != "gamma2":
        raise ValueError(f"unknown tonemap {tonemap!r} "
                         "(gamma2 | reinhard | aces)")
    return np.sqrt(avg)


def to_u8(image: np.ndarray) -> np.ndarray:
    return (np.clip(image, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def encode_png(image: np.ndarray) -> bytes:
    """Encode an (H, W, 3) float [0,1] or uint8 image as PNG bytes."""
    if image.dtype != np.uint8:
        image = to_u8(image)
    h, w, _ = image.shape
    raw = b"".join(b"\x00" + image[row].tobytes() for row in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) float [0,1] or uint8 image as PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(image))


def read_png(path: str) -> np.ndarray:
    """8-bit RGB/RGBA PNG reader (alpha dropped), all five row filters.

    Real-world encoders (Pillow, GIMP) emit Sub/Up/Average/Paeth row
    filters, and scene files may reference such images — so this is a
    small but complete baseline-PNG decoder for non-interlaced 8-bit
    truecolor.  Other color types / bit depths raise ValueError.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, w, h, channels = 8, b"", 0, 0, 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color, _comp, _filt, interlace = struct.unpack(
                ">IIBBBBB", body[:13])
            if depth != 8 or color not in (2, 6) or interlace:
                raise ValueError(
                    f"{path}: only non-interlaced 8-bit RGB/RGBA PNGs "
                    f"are supported (depth={depth}, color type={color})")
            channels = 3 if color == 2 else 4
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    bpp = channels
    stride = w * bpp + 1
    if len(raw) < h * stride:
        raise ValueError(f"{path}: truncated image data")
    out = np.zeros((h, w * bpp), np.uint8)
    prev = np.zeros(w * bpp, np.uint8)
    for r in range(h):
        ftype = raw[r * stride]
        cur = np.frombuffer(raw[r * stride + 1 : (r + 1) * stride],
                            np.uint8).astype(np.int32)
        if ftype == 0:
            line = cur
        elif ftype == 2:                     # Up
            line = (cur + prev) & 0xFF
        elif ftype in (1, 3, 4):             # Sub / Average / Paeth
            line = np.zeros(w * bpp, np.int32)
            pv = prev.astype(np.int32)
            for i in range(w * bpp):
                a = line[i - bpp] if i >= bpp else 0
                b = pv[i]
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = pv[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if (pa <= pb and pa <= pc) else \
                        (b if pb <= pc else c)
                line[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"{path}: unknown PNG filter {ftype}")
        prev = line.astype(np.uint8)
        out[r] = prev
    return out.reshape(h, w, bpp)[..., :3]


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Root-mean-square error, the BASELINE correctness gate (<1e-3)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def save_checkpoint(path: str, accumulated: np.ndarray, samples: int,
                    frame: int = 0, meta: dict | None = None) -> None:
    """Checkpoint progressive accumulation (absent in the reference —
    its accumulator dies on exit, SURVEY.md §5).

    ``meta`` (width/height/scene/engine/...) is stored alongside and
    validated on resume so a checkpoint from a different render can't be
    silently blended into this one.
    """
    meta_items = {f"meta_{k}": np.asarray(str(v)) for k, v in (meta or {}).items()}
    np.savez(path, accumulated=accumulated, samples=samples, frame=frame,
             **meta_items)


def load_checkpoint(path: str, expect_meta: dict | None = None):
    """Load a checkpoint; raises ValueError on metadata mismatch."""
    z = np.load(path)
    if expect_meta:
        for k, v in expect_meta.items():
            key = f"meta_{k}"
            if key in z.files and str(z[key]) != str(v):
                raise ValueError(
                    f"checkpoint {path} was written with {k}={z[key]} "
                    f"but this render uses {k}={v}; refusing to blend"
                )
    return z["accumulated"], int(z["samples"]), int(z["frame"])
