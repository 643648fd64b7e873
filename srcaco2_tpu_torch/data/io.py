"""Host-side image IO (port of srcaco2_tpu/data/io.py).

With cv2 (where it imports), the JAX package's behaviour: tif read as
is, grayscale kept as one channel, BGR -> RGB for color. Without cv2,
a small numpy codec: 8- or 16-bit grayscale and RGB baseline TIFF
without compression is read and written (imread_uint scales 16 bits
down as the JAX package does, imread_unchanged keeps them), and PNG is
written with zlib. A compressed TIFF, or any
other format, raises an error that names cv2. A machine without cv2
writes and reads the synthetic dataset through this codec.
"""
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

try:
    import cv2
except ImportError:
    cv2 = None

_NEEDS_CV2 = 'install opencv-python (cv2) to read it'


# ------------------------------------------------------------ numpy TIFF
_TYPE_SIZE = {1: 1, 3: 2, 4: 4}
_TYPE_FMT = {1: 'B', 3: 'H', 4: 'I'}


def write_tiff(path: str, img: np.ndarray) -> None:
    """img: (H, W) or (H, W, 3) uint8 or uint16 -> an uncompressed
    baseline TIFF (little-endian, one strip)."""
    img = np.ascontiguousarray(img)
    if img.dtype not in (np.uint8, np.uint16) or img.ndim not in (2, 3) \
            or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f'write_tiff: (H, W) or (H, W, 3) uint8 or '
                         f'uint16, got {img.dtype} {img.shape}')
    h, w = img.shape[:2]
    spp = 1 if img.ndim == 2 else 3
    bps = 8 * img.dtype.itemsize
    data = img.astype(img.dtype.newbyteorder('<')).tobytes()
    data_off = 8
    bps_off = data_off + len(data)
    extra = struct.pack('<3H', bps, bps, bps) if spp == 3 else b''
    ifd_off = bps_off + len(extra)
    ifd_off += ifd_off % 2
    # (tag, type, count, value): SHORT = 3, LONG = 4
    entries = [(256, 4, 1, w), (257, 4, 1, h),
               (258, 3, spp, bps_off if spp == 3 else bps),
               (259, 3, 1, 1), (262, 3, 1, 1 if spp == 1 else 2),
               (273, 4, 1, data_off), (277, 3, 1, spp), (278, 4, 1, h),
               (279, 4, 1, len(data)), (284, 3, 1, 1)]
    out = bytearray(b'II*\x00' + struct.pack('<I', ifd_off))
    out += data + extra
    out += b'\x00' * (ifd_off - len(out))
    out += struct.pack('<H', len(entries))
    for tag, typ, count, value in entries:
        if typ == 3 and count == 1:
            out += struct.pack('<HHIHH', tag, typ, count, value, 0)
        else:
            out += struct.pack('<HHII', tag, typ, count, value)
    out += struct.pack('<I', 0)
    with open(path, 'wb') as f:
        f.write(bytes(out))


def read_tiff(path: str) -> np.ndarray:
    """An uncompressed grayscale or RGB TIFF (8 or 16 bits per sample,
    strips, chunky) -> (H, W) or (H, W, 3) array of its own dtype."""
    with open(path, 'rb') as f:
        buf = f.read()
    if buf[:4] not in (b'II*\x00', b'MM\x00*'):
        raise ValueError(f'{path}: not a TIFF file; {_NEEDS_CV2}')
    e = '<' if buf[:2] == b'II' else '>'
    (ifd,) = struct.unpack_from(e + 'I', buf, 4)
    (n,) = struct.unpack_from(e + 'H', buf, ifd)
    tags = {}
    for i in range(n):
        tag, typ, count = struct.unpack_from(e + 'HHI', buf, ifd + 2 + 12 * i)
        if typ not in _TYPE_FMT:
            continue
        size = _TYPE_SIZE[typ] * count
        at = ifd + 2 + 12 * i + 8
        if size > 4:
            (at,) = struct.unpack_from(e + 'I', buf, at)
        tags[tag] = struct.unpack_from(e + _TYPE_FMT[typ] * count, buf, at)
    w, h = tags[256][0], tags[257][0]
    spp = tags.get(277, (1,))[0]
    bps = tags.get(258, (1,))[0]
    compression = tags.get(259, (1,))[0]
    photometric = tags.get(262, (1,))[0]
    planar = tags.get(284, (1,))[0]
    if compression != 1 or bps not in (8, 16) or spp not in (1, 3) or \
            planar != 1 or photometric not in (1, 2):
        raise ValueError(
            f'{path}: TIFF with compression {compression}, {bps} bits, '
            f'{spp} samples, planar {planar}, photometric {photometric} is '
            f'not read without cv2; {_NEEDS_CV2}')
    data = b''.join(buf[o:o + c] for o, c in zip(tags[273], tags[279]))
    dt = np.dtype(np.uint8) if bps == 8 else np.dtype(e + 'u2')
    img = np.frombuffer(data, dt, count=h * w * spp).reshape(h, w, spp)
    return img[..., 0] if spp == 1 else img


def write_png(path: str, img: np.ndarray) -> None:
    """img: (H, W) or (H, W, 3) uint8 -> an 8-bit grayscale or RGB PNG."""
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    rows = img.reshape(h, -1)
    raw = b''.join(b'\x00' + rows[i].tobytes() for i in range(h))

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body) & 0xffffffff))
    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n'
                + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, color,
                                             0, 0, 0))
                + chunk(b'IDAT', zlib.compress(raw, 6))
                + chunk(b'IEND', b''))


def _to_gray(img: np.ndarray) -> np.ndarray:
    """RGB -> gray with cv2's 15-bit fixed-point weights
    (COLOR_RGB2GRAY: 0.299, 0.587, 0.114)."""
    r, g, b = (img[..., i].astype(np.uint32) for i in range(3))
    return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15
            ).astype(img.dtype)


def _read(path: str, n_channels: int) -> np.ndarray:
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path)
        if n_channels == 1:
            if img.ndim == 3:
                img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
            return img[:, :, None]
        if img.ndim == 2:
            return cv2.cvtColor(img, cv2.COLOR_GRAY2RGB)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    img = read_tiff(path)
    if n_channels == 1:
        return (_to_gray(img) if img.ndim == 3 else img)[:, :, None]
    return np.stack([img] * 3, -1) if img.ndim == 2 else img


def imread_uint(path: str, n_channels: int = 1) -> np.ndarray:
    """Read an image as uint8 HWC with exactly n_channels (1 or 3)."""
    if n_channels not in (1, 3):
        raise ValueError(f'n_channels {n_channels}')
    img = _read(path, n_channels)
    if img.dtype != np.uint8:
        # 16-bit tifs: scale down to the uint8 range
        img = (img.astype(np.float32) * (255.0 / img.max())).astype(np.uint8)
    return img


def imread_unchanged(path: str, n_channels: int = 3) -> np.ndarray:
    """Read an image as HWC with exactly n_channels (1 or 3), RGB, in the
    dtype it is stored in (uint8 or uint16), as cv2's IMREAD_UNCHANGED
    reads it: imread_uint without its scaling to uint8."""
    if n_channels not in (1, 3):
        raise ValueError(f'n_channels {n_channels}')
    return _read(path, n_channels)


def imsave_unchanged(img: np.ndarray, path: str):
    """Save an HW / HWC (RGB) uint8 or uint16 image in its own dtype, as
    cv2.imwrite does (imsave rounds to uint8); without cv2, TIFF only."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f'imsave_unchanged: uint8 or uint16, got '
                         f'{img.dtype}')
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if cv2 is not None:
        if img.ndim == 3:
            img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
        if not cv2.imwrite(path, img):
            raise OSError(f'cv2 could not write {path}')
        return
    if os.path.splitext(path)[1].lower() not in ('.tif', '.tiff'):
        raise ValueError(f'{path}: only .tif is written in its own dtype '
                         f'without cv2')
    write_tiff(path, img)


def imsave(img: np.ndarray, path: str):
    """Save an HW / HWC uint8 (or [0, 255] float) image as png / tif."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(np.round(img), 0, 255).astype(np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if cv2 is not None:
        if img.ndim == 3:
            img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
        cv2.imwrite(path, img)
        return
    ext = os.path.splitext(path)[1].lower()
    if ext in ('.tif', '.tiff'):
        write_tiff(path, img)
    elif ext == '.png':
        write_png(path, img)
    else:
        raise ValueError(f'{path}: only .tif and .png are written without '
                         'cv2')


def read_image_stack(paths: List[str], n_channels: int = 1,
                     num_workers: int = 8) -> np.ndarray:
    """Decode a list of images into one (N, H, W, C) uint8 array with a
    thread pool: the host staging step of the device-resident pipeline
    (decode once, keep packed)."""
    if not paths:
        return np.zeros((0, 0, 0, n_channels), np.uint8)
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        imgs = list(ex.map(lambda p: imread_uint(p, n_channels), paths))
    shapes = {im.shape for im in imgs}
    if len(shapes) != 1:
        raise ValueError(f'inhomogeneous image sizes: {shapes}')
    return np.stack(imgs)


def cv2_resize_cubic_uint8(img: np.ndarray, out_wh) -> np.ndarray:
    """cv2 INTER_CUBIC resize of a uint8 HWC (or HW) image to (w, h),
    keeping a channel axis (reference: _resize_low_to_scale,
    dataset_dpsr.py:659). Without cv2, the port's torch bicubic
    (ops/resize.resize2d, a = -0.75) on the CPU, rounded and clipped."""
    if cv2 is not None:
        out = cv2.resize(img, dsize=tuple(out_wh),
                         interpolation=cv2.INTER_CUBIC)
    else:
        import torch
        from srcaco2_tpu_torch.ops.resize import resize2d
        a = img if img.ndim == 3 else img[:, :, None]
        x = torch.from_numpy(np.ascontiguousarray(
            a.astype(np.float32).transpose(2, 0, 1)))
        out = resize2d(x, (out_wh[1], out_wh[0])).numpy().transpose(1, 2, 0)
        out = np.clip(np.round(out), 0, 255).astype(img.dtype)
    if out.ndim == 2:
        out = out[:, :, None]
    return out
