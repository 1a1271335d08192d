"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

One ``nvcc`` process per source, all started together, compiles each file
to an object for ``sm_90a``; one more links the objects into a single
shared library with a plain C interface, which ``ctypes`` loads. Nothing
includes PyTorch's headers, so a cold build takes seconds.

The library lands in ``paddle_tpu_torch/_build/<digest>/`` (listed in
``.gitignore``), where the digest covers the sources, the headers and the
flags: an unchanged tree loads the existing build, a changed one builds
anew. The build runs at first use (``load()``), never at import.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["BuildInfo", "build", "load", "nvcc_path", "SOURCE_DIR",
           "BUILD_DIR"]

SOURCE_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
LIB_NAME = "libptt_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


@dataclasses.dataclass
class BuildInfo:
    path: Path                    # the shared library
    seconds: float                # wall time of this build (0 if cached)
    cached: bool                  # True when an existing build was reused
    logs: Dict[str, str]          # per source: nvcc/ptxas output


def nvcc_path() -> str:
    """nvcc from ``$CUDA_HOME``/``$CUDA_PATH``, else ``PATH``, else the
    toolkit's default prefix. Raises ``RuntimeError`` when none exists."""
    cands: List[str] = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH);"
                       " the CUDA kernels are built on the machine with "
                       "the card")


def _sources() -> List[Path]:
    return sorted(SOURCE_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(SOURCE_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _read_logs(out_dir: Path) -> Dict[str, str]:
    return {p.stem: p.read_text() for p in sorted(out_dir.glob("*.log"))}


def build(force: bool = False) -> BuildInfo:
    """Compile and link the kernels unless an identical build exists."""
    out_dir = BUILD_DIR / _digest()
    lib = out_dir / LIB_NAME
    if lib.is_file() and not force:
        return BuildInfo(lib, 0.0, True, _read_logs(out_dir))
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR, prefix="tmp-"))
    try:
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(SOURCE_DIR), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            (tmp / (src.stem + ".log")).write_text(out)
            if proc.returncode != 0:
                failed.append(f"{src.name} (rc {proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / LIB_NAME),
             *[str(obj) for _src, obj, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        try:
            os.replace(tmp, out_dir)
        except OSError:
            # another process finished the same build first: keep theirs
            if not lib.is_file():
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return BuildInfo(lib, time.perf_counter() - t0, False,
                     _read_logs(out_dir))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, F, LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    lib.ptt_fused_ln.argtypes = [P, P, P, P, I, I, F, I, P]
    lib.ptt_fused_ln.restype = I
    lib.ptt_decode_slab.argtypes = [P, P, P, LL, P, P, P, P, P, I, I, I, I,
                                    F, I, I, P]
    lib.ptt_decode_slab.restype = I
    lib.ptt_logits_head.argtypes = [P, P, P, P, P, I, I, I, F, I, P]
    lib.ptt_logits_head.restype = I
    fl = [P, P, P, P, P, I, I, I, I, LL, LL, LL, F, I, I, P]
    lib.ptt_flash_fwd.argtypes = fl
    lib.ptt_flash_fwd.restype = I
    lib.ptt_flash_bwd_dq.argtypes = [P, P, P, P, P, P, P, I, I, I, I, LL, LL,
                                     LL, F, I, I, P]
    lib.ptt_flash_bwd_dq.restype = I
    lib.ptt_flash_bwd_dkv.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, LL,
                                      LL, LL, F, I, I, P]
    lib.ptt_flash_bwd_dkv.restype = I
    lib.ptt_adamw_flat.argtypes = [P, P, P, P, P, P, LL, F, F, F, F, F, F, I,
                                   P]
    lib.ptt_adamw_flat.restype = I
    lib.ptt_error_string.argtypes = [I]
    lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and bound once per process."""
    global _lib
    with _lock:
        if _lib is None:
            info = build()
            _lib = _bind(ctypes.CDLL(str(info.path)))
        return _lib
