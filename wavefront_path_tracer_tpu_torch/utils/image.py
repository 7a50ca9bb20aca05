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


# --- GIF89a: an animation without Pillow --------------------------------

GIF_COLORS = 256


def quantize(image: np.ndarray, colors: int = GIF_COLORS):
    """(palette (n <= colors, 3) uint8, index (H, W) uint8) of an (H, W,
    3) uint8 image by median cut: the image's distinct colours, weighted
    by their pixel counts, are split at the weighted median of the widest
    channel of the box with the widest range (the first such box on a
    tie) until there are ``colors`` boxes; a box's colour is its
    weighted mean, rounded, and each pixel takes its colour's box.  An
    image of at most ``colors`` distinct colours keeps them exactly.
    Pillow's adaptive palette is another median cut and differs from
    this one in its choices, so the two do not agree bit for bit."""
    image = np.asarray(image, np.uint8)
    h, w, _ = image.shape
    uniq, inverse, counts = np.unique(image.reshape(-1, 3), axis=0,
                                      return_inverse=True,
                                      return_counts=True)
    inverse = inverse.reshape(-1)
    if len(uniq) <= colors:
        return uniq, inverse.reshape(h, w).astype(np.uint8)
    wide = uniq.astype(np.int64)

    def spread(box):
        c = wide[box]
        return int((c.max(0) - c.min(0)).max()) if len(box) > 1 else -1

    boxes = [np.arange(len(uniq))]
    spreads = [spread(boxes[0])]
    while len(boxes) < colors:
        k = int(np.argmax(spreads))
        if spreads[k] <= 0:
            break
        box = boxes.pop(k)
        spreads.pop(k)
        c = wide[box]
        channel = int(np.argmax(c.max(0) - c.min(0)))
        order = box[np.argsort(c[:, channel], kind="stable")]
        cum = np.cumsum(counts[order])
        cut = int(np.searchsorted(cum, cum[-1] / 2.0)) + 1
        cut = min(max(cut, 1), len(order) - 1)
        for part in (order[:cut], order[cut:]):
            boxes.append(part)
            spreads.append(spread(part))
    label = np.empty(len(uniq), np.int64)
    palette = np.empty((len(boxes), 3), np.uint8)
    for k, box in enumerate(boxes):
        label[box] = k
        weights = counts[box].astype(np.float64)
        palette[k] = np.round((wide[box] * weights[:, None]).sum(0)
                              / weights.sum())
    return palette, label[inverse].reshape(h, w).astype(np.uint8)


def _lzw(data: bytes, min_code_size: int = 8) -> bytes:
    """GIF's variable-width LZW code stream of ``data`` (clear code
    first, a clear code whenever the 4,096-entry table is full, the end
    code last)."""
    clear = 1 << min_code_size
    end = clear + 1
    width = min_code_size + 1
    table = {}
    next_code = end + 1
    out = bytearray()
    bits = nbits = 0

    def emit(code):
        nonlocal bits, nbits
        bits |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(bits & 0xFF)
            bits >>= 8
            nbits -= 8

    emit(clear)
    prefix = data[0]
    for byte in data[1:]:
        key = (prefix << 8) | byte
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            # The decoder adds each entry one code later, and widens its
            # codes when its table reaches 2**width.
            if next_code - 1 == (1 << width) and width < 12:
                width += 1
        else:
            emit(clear)
            table.clear()
            next_code = end + 1
            width = min_code_size + 1
        prefix = byte
    emit(prefix)
    emit(end)
    if nbits:
        out.append(bits & 0xFF)
    return bytes(out)


def encode_gif(frames, ms_per_frame: int = 80, loop: int = 0):
    """An animated GIF89a of the (H, W, 3) frames (float [0, 1] or
    uint8): each frame quantised to 256 colours (:func:`quantize`) in a
    local colour table, a delay of ``ms_per_frame`` in the graphic
    control extension (in hundredths of a second, as the format stores
    it), and the NETSCAPE2.0 loop extension (``loop`` 0: for ever).
    Returns (the file's bytes, [(palette, index)] of each frame)."""
    frames = [f if f.dtype == np.uint8 else to_u8(f) for f in frames]
    h, w, _ = frames[0].shape
    out = bytearray(b"GIF89a")
    out += struct.pack("<HHBBB", w, h, 0x70, 0, 0)  # no global table
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop)
    out += b"\x00"
    quantised = []
    for frame in frames:
        if frame.shape != (h, w, 3):
            raise ValueError("every frame must have the first's shape")
        palette, index = quantize(frame)
        quantised.append((palette, index))
        table = np.zeros((GIF_COLORS, 3), np.uint8)
        table[:len(palette)] = palette
        out += b"\x21\xf9\x04\x04" + struct.pack(
            "<H", int(round(ms_per_frame / 10))) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87)
        out += table.tobytes() + b"\x08"
        code = _lzw(index.tobytes())
        for k in range(0, len(code), 255):
            chunk = code[k:k + 255]
            out += bytes([len(chunk)]) + chunk
        out += b"\x00"
    out += b"\x3b"
    return bytes(out), quantised


def write_gif(path: str, frames, ms_per_frame: int = 80,
              loop: int = 0) -> list:
    """Write :func:`encode_gif`'s file; its frames' (palette, index)."""
    data, quantised = encode_gif(frames, ms_per_frame, loop)
    with open(path, "wb") as f:
        f.write(data)
    return quantised


def read_gif_info(path: str) -> dict:
    """The structure of a GIF file, its image data skipped: {width,
    height, frames, delays_ms (each graphic control extension's delay),
    loop (the NETSCAPE2.0 count, or None)}.  Raises ValueError on a file
    that is not a whole GIF."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path}: not a GIF file")
    w, h, packed = struct.unpack("<HHB", data[6:11])
    pos = 13
    if packed & 0x80:
        pos += 3 << ((packed & 7) + 1)

    def skip_blocks(p):
        while data[p]:
            p += data[p] + 1
        return p + 1

    info = {"width": w, "height": h, "frames": 0, "delays_ms": [],
            "loop": None}
    while True:
        if pos >= len(data):
            raise ValueError(f"{path}: ends before its trailer")
        tag = data[pos]
        if tag == 0x3B:
            return info
        if tag == 0x21:
            label = data[pos + 1]
            if label == 0xF9:
                info["delays_ms"].append(
                    10 * struct.unpack("<H", data[pos + 4:pos + 6])[0])
            elif label == 0xFF and data[pos + 3:pos + 14] == b"NETSCAPE2.0":
                info["loop"] = struct.unpack("<H", data[pos + 16:pos + 18])[0]
            pos = skip_blocks(pos + 2)
        elif tag == 0x2C:
            local = data[pos + 9]
            pos += 10
            if local & 0x80:
                pos += 3 << ((local & 7) + 1)
            pos = skip_blocks(pos + 1)          # the LZW minimum code size
            info["frames"] += 1
        else:
            raise ValueError(f"{path}: unknown block 0x{tag:02x} at {pos}")
