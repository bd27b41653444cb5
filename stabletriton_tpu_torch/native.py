"""The native host library: checkpoint widening and transposes, image output
(RGB8, PNG) and the CLIP BPE tokenizer, in C++ behind a C ABI.

Counterpart of ``stabletriton_tpu/native.py``, with the same C entry points,
built from the same sources (``native/src/*.cpp``). The library is compiled
with ``g++`` at first use into ``build/native/<hash>/`` beside the package
(``build/`` is git-ignored), keyed by a hash of the sources and the flags, so
an edited source rebuilds and an unchanged one loads the cached library; the
library a ``make`` in ``native/`` would leave there is never loaded. A build
that fails raises with the compiler's output: no entry goes on in numpy in
its place.

Each entry takes and returns numpy arrays on the host. Its ``*_plain``
twin computes the same function in numpy; the tests hold each entry
against it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

REPO_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = REPO_DIR / "native" / "src"
BUILD_ROOT = REPO_DIR / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
LIBS = ("-lz", "-lpthread")  # zlib: the PNG encoder's deflate
LIB_NAME = "libst_native.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cpp"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources if no library for their hash exists (one
    ``g++ -c`` per source, all started together, then one link); return its
    path. Raises RuntimeError with the compiler's output if the build
    fails."""
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("building the native library needs a C++ compiler (g++ or $CXX)")
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    jobs = []
    for src in sources():
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [cxx, *CXX_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    if not failed:
        cmd = [cxx, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs), *LIBS]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(f"$ {' '.join(cmd)}\n{proc.stdout}")
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{proc.stdout}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    (out_dir / "g++.log").write_text("\n".join(logs))
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("building the native library failed:\n" + "\n".join(failed))
    os.replace(tmp, lib_path)  # atomic: concurrent builders never see half a file
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build())))
        return _lib


def _declare(l: ctypes.CDLL) -> ctypes.CDLL:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    for name, args, res in [
            ("st_bf16_to_f32", [p, p, i64], None),
            ("st_f16_to_f32", [p, p, i64], None),
            ("st_transpose_2d", [p, p, i64, i64], None),
            ("st_oihw_to_hwio", [p, p, i64, i64, i64, i64], None),
            ("st_float_to_rgb8", [p, p, i64], None),
            ("st_encode_png", [p, i64, i64, ctypes.POINTER(p)], i64),
            ("st_free", [p], None),
            ("st_tok_create", [ctypes.c_char_p, ctypes.c_char_p], p),
            ("st_tok_free", [p], None),
            ("st_tok_encode", [p, ctypes.c_char_p, p, i32, i32, i32, i32], i32),
            ("st_tok_vocab_size", [p], i32)]:
        fn = getattr(l, name)
        fn.argtypes, fn.restype = args, res
    return l


def have_native() -> bool:
    """Whether the library builds and loads here."""
    try:
        lib()
    except (RuntimeError, OSError):
        return False
    return True


def _f32(x: np.ndarray, what: str) -> np.ndarray:
    if x.dtype != np.float32:
        raise TypeError(f"{what} takes float32, got {x.dtype}")
    return np.ascontiguousarray(x)


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------


def bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    """uint16 bf16 payloads -> float32."""
    raw = np.ascontiguousarray(raw, dtype=np.uint16)
    out = np.empty(raw.shape, np.float32)
    lib().st_bf16_to_f32(raw.ctypes.data, out.ctypes.data, raw.size)
    return out


def bf16_to_f32_plain(raw: np.ndarray) -> np.ndarray:
    return (np.asarray(raw, np.uint16).astype(np.uint32) << 16).view(np.float32)


def f16_to_f32(raw: np.ndarray) -> np.ndarray:
    """uint16 f16 payloads -> float32 (subnormals, infinities and NaN kept)."""
    raw = np.ascontiguousarray(raw, dtype=np.uint16)
    out = np.empty(raw.shape, np.float32)
    lib().st_f16_to_f32(raw.ctypes.data, out.ctypes.data, raw.size)
    return out


def f16_to_f32_plain(raw: np.ndarray) -> np.ndarray:
    return np.asarray(raw, np.uint16).view(np.float16).astype(np.float32)


def transpose_2d(x: np.ndarray) -> np.ndarray:
    """(rows, cols) float32 -> (cols, rows), contiguous."""
    x = _f32(x, "transpose_2d")
    out = np.empty((x.shape[1], x.shape[0]), np.float32)
    lib().st_transpose_2d(x.ctypes.data, out.ctypes.data, x.shape[0], x.shape[1])
    return out


def transpose_2d_plain(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.T)


def oihw_to_hwio(x: np.ndarray) -> np.ndarray:
    """A float32 conv weight (O, I, H, W) -> (H, W, I, O), contiguous."""
    x = _f32(x, "oihw_to_hwio")
    o, i, h, w = x.shape
    out = np.empty((h, w, i, o), np.float32)
    lib().st_oihw_to_hwio(x.ctypes.data, out.ctypes.data, o, i, h, w)
    return out


def oihw_to_hwio_plain(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.transpose(2, 3, 1, 0))


# ---------------------------------------------------------------------------
# image output
# ---------------------------------------------------------------------------


def to_rgb8(img: np.ndarray) -> np.ndarray:
    """[-1, 1] float image -> uint8 (round half up, clamped)."""
    img = np.ascontiguousarray(img, np.float32)
    out = np.empty(img.shape, np.uint8)
    lib().st_float_to_rgb8(img.ctypes.data, out.ctypes.data, img.size)
    return out


def to_rgb8_plain(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float32)
    return np.clip((img + np.float32(1.0)) * np.float32(127.5) + np.float32(0.5),
                   0, 255).astype(np.uint8)


def _check_rgb8(rgb8: np.ndarray) -> np.ndarray:
    if rgb8.ndim != 3 or rgb8.shape[2] != 3 or rgb8.dtype != np.uint8:
        raise ValueError(f"PNG encode takes (H, W, 3) uint8, got {rgb8.shape} {rgb8.dtype}")
    return np.ascontiguousarray(rgb8)


def encode_png(rgb8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (filter 0 rows, zlib's deflate)."""
    rgb8 = _check_rgb8(rgb8)
    l = lib()
    buf = ctypes.c_void_p()
    n = l.st_encode_png(rgb8.ctypes.data, rgb8.shape[1], rgb8.shape[0], ctypes.byref(buf))
    if n < 0:
        raise RuntimeError("native PNG encode failed")
    try:
        return ctypes.string_at(buf, n)
    finally:
        l.st_free(buf)


def encode_png_plain(rgb8: np.ndarray) -> bytes:
    rgb8 = _check_rgb8(rgb8)
    h, w, _ = rgb8.shape
    raw = b"".join(b"\x00" + rgb8[y].tobytes() for y in range(h))

    def chunk(typ, data):
        c = typ + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def save_png(img: np.ndarray, path) -> None:
    """[-1, 1] float (H, W, 3) -> PNG file."""
    Path(path).write_bytes(encode_png(to_rgb8(img)))
