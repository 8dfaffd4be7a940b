"""Build and load the port's CUDA kernels (``csrc/*.cu``).

At first use every ``.cu`` file under the package's ``csrc/`` is compiled by
its own plain ``nvcc`` process, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -c -o <tmp>/<name>.o csrc/<name>.cu

then linked into one shared library with a C interface
(``nvcc ... -shared -o build/ilps_torch_kernels/libilps_<hash>.so <tmp>/*.o``)
and loaded with ``ctypes``. The file name carries a hash of the sources and
flags, so an edited source rebuilds and an unchanged one is reused. No
PyTorch header is included, which keeps the build to seconds.

Calling convention of every entry point: pointers and the CUDA stream are
``c_void_p`` (a plain ``c_int`` would truncate a 64-bit pointer), sizes are
``c_int`` and scalars ``c_float``; the function launches on the given stream
(``torch.cuda.current_stream().cuda_stream``) and returns
``cudaGetLastError()``. :func:`launch` raises on a non-zero code.

There is no fallback: without ``nvcc``, or when the build fails, this raises.

Launch counters: each kernel wrapper calls :func:`count` exactly where it
launches its kernel, so a run can show which kernels the main path went
through (``reset_counts`` / ``counts``). Under a CUDA graph the card runs a
kernel on every replay and the wrapper runs once, at capture:
``utils/graphs.py`` takes the capture's counts back (``set_counts``) and
adds them on each replay, so the counts stay the launches the card ran.
The counts live in the port's one counter registry, ``utils/tracing.py``,
as its ``launch.`` counters: ``counts`` gives them under bare kernel names,
``set_counts`` replaces only them, and ``reset_counts`` clears the whole
registry.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

from indirect_learning_pose_shape_tpu_torch.utils import tracing

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "ilps_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_entries: dict[str, ctypes._CFuncPtr] = {}
_LAUNCH = "launch."


def count(name: str, n: int = 1) -> None:
    """Add `n` launches of kernel `name` (the wrappers add one where they
    launch; a graph's replay adds what its capture recorded)."""
    tracing.count(_LAUNCH + name, n)


def counts() -> dict[str, int]:
    """The launch counts, by kernel name."""
    return tracing.counters(_LAUNCH)


def reset_counts() -> None:
    """Clear every counter of the registry, launches and the others."""
    tracing.reset_counts()


def set_counts(saved: dict[str, int]) -> None:
    """Put the launch counts back to `saved` (a `counts()` taken earlier)."""
    tracing.set_counters(_LAUNCH, saved)


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels cannot be built"
    )


def _sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def _library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libilps_{h.hexdigest()[:16]}.so"


def _run(cmd: list[str], proc: subprocess.Popen) -> None:
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")


def build() -> Path:
    """Compile csrc/*.cu into the hashed library unless it already exists:
    one nvcc process per source, in parallel, then one link."""
    out = _library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in _sources()]
        jobs = []
        for src, obj in zip(_sources(), objs):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )))
        try:
            for cmd, proc in jobs:
                _run(cmd, proc)
        finally:
            for _, proc in jobs:  # stop every compiler still running after a failure
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        # Link to a temporary name and rename: a concurrent process never
        # loads a half-written library.
        lib = Path(tmp) / out.name
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *objs]
        _run(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        os.replace(lib, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = ctypes.CDLL(str(build()))
    return _lib


def entry(fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """Entry point `fn_name` with its argument types set, resolved once."""
    fn = _entries.get(fn_name)
    if fn is None:
        fn = getattr(library(), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[fn_name] = fn
    return fn


def launch(fn_name: str, *args) -> None:
    """Call entry point `fn_name` with `args` = (ctypes type, value) pairs.

    The entry point is resolved and typed on its first call only. Raises if
    it returns a CUDA error: a refused launch never runs and a later
    synchronize would not report it.
    """
    fn = entry(fn_name, (t for t, _ in args))
    err = fn(*(v for _, v in args))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {fn_name} failed to launch: cudaError {err}")
