"""Build the port's CUDA kernels with ``nvcc`` into shared libraries with a
plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` builds at first use into ``_build/`` (listed in
``.gitignore``) as ``lib<name>-<digest>.so``, where the digest covers the
source and that kernel's flags, so an edited source or flag never loads a
stale library.
The compiler's register/shared-memory report (``-Xptxas -v``) is kept
beside it as ``lib<name>-<digest>.log``.  Nothing here runs at import
time: the CPU tests import every module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
# each kernel's own flags: the bit equality of the fan-in kernel and
# pig_aggregate with their plain versions needs every multiply and add
# rounded on its own (no FMA contraction); the draws' one float64 log1p
# rounds as PyTorch's CUDA log1p with or without it (all 2**23 uniforms
# checked on the card), and keeps nvcc's default, which PyTorch is built with
KERNEL_FLAGS = {"seg_fanin_sm90": ("-fmad=false",), "flash_attention": (),
                "flash_attention_sm90": (),
                "pig_aggregate": ("-fmad=false",), "ssm_scan": (),
                "ssm_scan_sm90": (), "threefry_draws_sm90": ()}
# libraries built in one build_all call, whichever of them is loaded first:
# the step loops' fan-in and draws, so that a checkout's first grid
# runs both nvcc processes side by side
BUILT_TOGETHER = (("seg_fanin_sm90", "threefry_draws_sm90"),)


def nvcc() -> str:
    """The CUDA compiler: on ``PATH``, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           f"{home}/bin); the CUDA kernels cannot be built")
    return path


def flags(name: str) -> tuple:
    return NVCC_FLAGS + KERNEL_FLAGS[name]


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names) -> list:
    """Compile every ``csrc/<name>.cu`` whose library is not built yet, one
    ``nvcc`` per source, all started together; return the libraries' paths.
    Raises with the compiler's output when an ``nvcc`` fails."""
    outs = [library_path(n) for n in names]
    jobs = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, cmd, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    return the library's path."""
    return build_all([name])[0]


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>``; the libraries built
    together with it (``BUILT_TOGETHER``) are built in the same call."""
    group = next((g for g in BUILT_TOGETHER if name in g), (name,))
    return ctypes.CDLL(str(build_all(group)[group.index(name)]))
