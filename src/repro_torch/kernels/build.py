"""Builds the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` has a plain C interface. ``nvcc`` compiles it for
``sm_90a`` into a shared library under ``build/kernels/`` at the repo root
(listed in ``.gitignore``); the file name carries a hash of the source and
the flags, so an edit rebuilds and an unchanged source is reused. The
library is loaded with ``ctypes``. A failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Built:
    path: Path
    log: str          # the nvcc command line and its -Xptxas -v report


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    # the toolkit's default install prefix when nvcc is not on PATH
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build(name: str) -> Built:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode} on {src}:\n"
                               f"{proc.stdout}{proc.stderr}")
        log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    return Built(lib, log.read_text())


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name).path))
