"""Native (C++) host image path: build on first use + ctypes binding.

Port of `uvhand_tpu/native/__init__.py`. `pipeline.cpp` (a copy of the JAX
package's, its arithmetic unchanged) fuses the per-sample image work of
`ArcticDataset.__getitem__` -- JPEG decode, Gaussian pre-blur, affine
crop/rotate, pixel noise, [0, 1] and mean/std normalisation -- into one C
call that releases the GIL, so the loader's worker threads scale.

The library is compiled with the host's g++ against OpenCV 4
(`/usr/include/opencv4`) and libjpeg at first use, into `build/native/` at
the root of the checkout, keyed by the source's hash; nothing else is read.
Unlike the JAX package's loader, a library that cannot be built is an error:
`load()` raises `NativeBuildError` with the compiler's stderr, and the
dataset that asked for the native path raises with it (no silent fall back
to the Python path).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("pipeline.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
#: the compiler and the libraries the build links
COMPILER = "g++"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-I/usr/include/opencv4")
LIBS = ("-lopencv_core", "-lopencv_imgproc", "-lopencv_imgcodecs", "-ljpeg")

_LOCK = threading.Lock()
_LIB = None

_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


class NativeBuildError(RuntimeError):
    """The native library could not be compiled or loaded on this host."""


def build(source: Path | None = None, build_dir: Path | None = None) -> Path:
    """Compile `source` (`SOURCE`) into `build_dir` (`BUILD_DIR`), once per
    source hash; returns the shared library's path. Raises NativeBuildError
    with the compiler's stderr."""
    source, build_dir = Path(source or SOURCE), Path(build_dir or BUILD_DIR)
    tag = hashlib.sha256(source.read_bytes() + " ".join(FLAGS + LIBS).encode())
    so = build_dir / f"libuvpipeline_{tag.hexdigest()[:16]}.so"
    if so.exists():
        return so
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")  # concurrent builders race
    cmd = [COMPILER, *FLAGS, str(source), "-o", str(tmp), *LIBS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"{' '.join(cmd)} exited with {res.returncode}:\n{res.stderr}")
    os.replace(tmp, so)  # atomic; the last writer wins with identical bytes
    return so


def load() -> ctypes.CDLL:
    """Compile (once) and load the library. Raises NativeBuildError."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            so = build()
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as e:
                raise NativeBuildError(f"{so} does not load: {e}") from e
            f = ctypes.c_float
            fp = ctypes.POINTER(ctypes.c_float)
            lib.uv_process_image.restype = ctypes.c_int
            lib.uv_process_image.argtypes = [ctypes.c_char_p, f, f, f, f, fp, fp, fp,
                                             ctypes.c_int, ctypes.c_int, fp]
            _LIB = lib
        return _LIB


def process_image(path: str, center, bbox_dim: float, augm: dict, img_res: int,
                  fast: bool = False, mean=_MEAN, std=_STD) -> np.ndarray | None:
    """Fused equivalent of `cv2.imread` + `augment.rgb_processing` +
    `augment.normalize_image` (`data/arctic.py::ArcticDataset._load_image`).

    Returns the normalized (img_res, img_res, 3) float32 RGB image, or None
    when the file cannot be decoded by the C call (a PNG, a missing file) or
    the crop is empty: the caller then takes the Python path, which gives
    the zero image and is_valid 0 for a missing file. `fast` decodes at the
    smallest libjpeg scale that keeps the crop at least img_res wide
    (geometry exact, pixels approximate). Raises NativeBuildError where the
    library cannot be built."""
    lib = load()
    # crop_dim exactly as rgb_processing computes it: int(sc * bbox_dim * 200)
    crop_dim = float(int(augm["sc"] * bbox_dim * 200))
    if crop_dim <= 0:
        return None
    pn = np.ascontiguousarray(augm["pn"][:3], np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    out = np.empty((img_res, img_res, 3), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    rc = lib.uv_process_image(
        path.encode(), ctypes.c_float(float(center[0])), ctypes.c_float(float(center[1])),
        ctypes.c_float(crop_dim), ctypes.c_float(float(augm["rot"])),
        pn.ctypes.data_as(fp), mean.ctypes.data_as(fp), std.ctypes.data_as(fp), img_res,
        int(fast), out.ctypes.data_as(fp))
    return out if rc == 0 else None
