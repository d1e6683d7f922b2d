"""Build and load the port's CUDA kernels (``mlapi_tpu_torch/csrc``).

Each ``.cu`` source under ``csrc/`` compiles with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded
through ``ctypes`` — no PyTorch headers, so a build takes seconds, not
minutes. A source compiles as several translation units (``UNITS``):
``-DMLAPI_UNIT=D`` holds the kernels of compiled head dim ``D``,
``-DMLAPI_UNIT=0`` the C entry points; the objects link into one
library. Libraries are built at first use from the sources in the
checkout and cached under a key that hashes the source, the headers
beside it (``csrc/*.cuh``) and the flags,
in ``build/kernels/`` at the repository root (``.gitignore`` lists
``build/``), or in ``$MLAPI_TPU_TORCH_BUILD_DIR``. :func:`build`
starts one ``nvcc`` per unit of every missing source, all at once.

Nothing here runs at import time: the CPU test suite imports every
module of the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
SOURCES = ("decode_attention", "flash_attention")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Translation units of every source: the entry points, then one per
# compiled head dim.
UNITS = (0, 16, 32, 64, 128, 256)


@dataclass
class Built:
    """One compiled library: its path and what ``ptxas -v`` said about
    registers, shared memory and spills."""

    name: str
    path: Path
    log: str


_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("MLAPI_TPU_TORCH_BUILD_DIR")
    return Path(env) if env else REPO_ROOT / "build" / "kernels"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels build from "
        "source at first use"
    )


def _target(name: str) -> Path:
    # The source and every header beside it (both sources include them).
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    flags = " ".join(NVCC_FLAGS) + f" units {UNITS}"
    key = hashlib.sha256(src + flags.encode()).hexdigest()
    return build_dir() / key[:16] / f"lib{name}.so"


def _run(cmd) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build(names=SOURCES) -> dict[str, Built]:
    """Compile every named source whose library is not cached yet: one
    ``nvcc -c`` process per unit of every such source, all started
    together, then one link per source; raise with the compiler's output
    if any step fails."""
    out: dict[str, Built] = {}
    jobs = []
    for name in names:
        target = _target(name)
        log_path = target.with_suffix(".log")
        if target.exists():
            log = log_path.read_text() if log_path.exists() else ""
            out[name] = Built(name, target, log)
            continue
        target.parent.mkdir(parents=True, exist_ok=True)
        # Build under private names, then rename: concurrent builds of
        # the same key never see a half-written library.
        stem = f".{name}.{os.getpid()}"
        objs = [target.with_name(f"{stem}.{u}.o") for u in UNITS]
        compiles = [_run([_nvcc(), *NVCC_FLAGS, f"-DMLAPI_UNIT={u}", "-c",
                          "-o", str(obj), str(CSRC / f"{name}.cu")])
                    for u, obj in zip(UNITS, objs)]
        jobs.append((name, target, log_path, objs, compiles))
    errors = []
    for name, target, log_path, objs, compiles in jobs:
        logs = [proc.communicate()[0] for proc in compiles]
        if any(proc.returncode for proc in compiles):
            errors.append(f"nvcc failed for {name}.cu:\n" + "".join(logs))
            continue
        tmp = target.with_name(f".{target.name}.{os.getpid()}.tmp")
        link = _run([_nvcc(), *ARCH, "-shared", "-o", str(tmp),
                     *map(str, objs)])
        logs.append(link.communicate()[0])
        for obj in objs:
            obj.unlink(missing_ok=True)
        log = "".join(logs)
        if link.returncode != 0:
            errors.append(f"nvcc could not link {name}:\n{log}")
            continue
        log_path.write_text(log)
        os.replace(tmp, target)
        out[name] = Built(name, target, log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name].path))
            _loaded[name] = lib
        return lib
