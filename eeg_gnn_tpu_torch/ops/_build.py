"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, ``_build/lib<name>-<sha>.so`` inside the package, where ``<sha>``
hashes the source, the ``csrc/*.cuh`` headers it may include and the
compiler flags: an edited source or header builds anew, an unchanged one
is loaded as it is. The build runs at first use, never
at import, and only on a machine with ``nvcc`` (``$PATH`` first, then
``/usr/local/cuda/bin``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

from eeg_gnn_tpu_torch.utils.profiling import timed

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "eeg_gnn_tpu_torch build only where the CUDA "
                       "toolkit is installed")


def library_path(name: str, defines: tuple = ()) -> str:
    """Where ``csrc/<name>.cu`` builds to (content-addressed: the source,
    the shared ``csrc/*.cuh`` headers, the flags and any ``-D`` defines)."""
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    digest = hashlib.sha256()
    for f in (name + ".cu", *headers):
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            digest.update(fh.read())
    digest.update(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(name: str, defines: tuple = ()) -> tuple[str, float, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists; ``defines``
    (``-DNAME`` flags) build a variant of it, such as a probe build.

    Returns (library path, build seconds, nvcc's ptxas report). The
    library is written to a temporary name and renamed into place, so
    concurrent processes never load a half-written file.
    """
    out = library_path(name, defines)
    if os.path.exists(out):
        return out, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-o", tmp,
           os.path.join(CSRC_DIR, name + ".cu")]
    with timed("eeg.setup.kernel_build") as nvcc:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out, nvcc.seconds, proc.stderr


@functools.lru_cache(maxsize=None)
@timed("eeg.setup.kernels")
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per name
    (the first load of each is timed as ``eeg.setup.kernels``)."""
    path, _, _ = build(name)
    return ctypes.CDLL(path)
