"""Build and load the hand-written CUDA kernels.

Every ``stabletriton_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` into ONE shared library with a plain C interface, loaded with
``ctypes``: one ``nvcc -c`` per source, all started together, then one link.
The build happens at first use, in ``build/torch_kernels/<hash>/``
beside the package (listed in ``.gitignore``), keyed by a hash of the sources
and the flags, so an edited source rebuilds and an unchanged one loads the
cached library. A plain-C library builds in seconds, where a PyTorch C++
extension would take minutes.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code, so a refused launch (too much shared
memory, too many threads) never passes silently.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libst_kernels.so"

# the codes every C entry point takes for its dtype and activation arguments
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ACT_CODES = {None: 0, "silu": 1, "gelu": 2}
# the activations the conv and GroupNorm kernels apply; the linear kernel
# takes every code above
SILU_ACTS = (None, "silu")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# filled by the build that produced the loaded library
build_info: dict = {}


def sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the sources if no library for their hash exists; return its path."""
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in (p for p in sources() if p.suffix == ".cu"):
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    if not failed:
        cmd = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o",
               str(tmp), *[str(obj) for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        logs.append(f"$ {' '.join(cmd)}\n{proc.stdout}")
        if proc.returncode != 0:
            failed.append(f"link failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}")
    seconds = time.perf_counter() - t0
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    (out_dir / "nvcc.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, lib_path)  # atomic: concurrent builders never see half a file
    build_info.update(path=str(lib_path), seconds=seconds, cached=False,
                      log=str(out_dir / "nvcc.log"))
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


_functions: dict[str, ctypes._CFuncPtr] = {}


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """A C entry point with its argument types declared (every pointer and
    the stream as ``c_void_p``, so ctypes does not cut them to 32 bits),
    looked up once: the eager step launches hundreds of kernels."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def on_device(device: torch.device):
    """Makes ``device`` the current CUDA device for a launch (the C entry
    points launch on the current device); nothing to do, and no host time
    spent, when it already is. The caller holds a tensor on ``device``, so
    CUDA is initialised: the current device is read without
    ``torch.cuda.current_device``'s initialisation check."""
    if device.index is None or device.index == torch._C._cuda_getDevice():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def current_stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current CUDA stream, for a C entry,
    through the accessor PyTorch's own generated launchers use: it makes no
    ``torch.cuda.Stream`` object, which costs microseconds of host time on
    every launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


# the tally of the CUDA graph this thread is capturing, if any (recording)
_capturing = threading.local()


class LaunchCounter:
    """Counts a wrapper's kernel launches that run, in total and by a key
    naming the kernel variant and shape, so a run can show that its main
    path really went through the kernel. Only the wrapper's launch site adds
    to it. A launch made while this thread captures a CUDA graph runs only
    when the graph replays: it goes to the graph's tally (:func:`recording`),
    and each replay adds the tally (:func:`count_replay`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.by_key: dict[str, int] = {}

    def add(self, key: str, n: int = 1) -> None:
        tally = getattr(_capturing, "tally", None)
        if tally is not None:
            tally[self, key] = tally.get((self, key), 0) + n
            return
        with self._lock:
            self.count += n
            self.by_key[key] = self.by_key.get(key, 0) + n

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.by_key = {}


@contextlib.contextmanager
def recording():
    """While entered, the launches this thread's wrappers make go to the
    yielded tally, {(counter, key): launches}, instead of their counters:
    the launches of a CUDA graph being captured, which run at each replay."""
    outer = getattr(_capturing, "tally", None)
    _capturing.tally = tally = {}
    try:
        yield tally
    finally:
        _capturing.tally = outer


def count_replay(tally: dict) -> None:
    """Adds one replay of a captured graph's launches (its tally from
    :func:`recording`) to the counters."""
    for (counter, key), n in tally.items():
        counter.add(key, n)
