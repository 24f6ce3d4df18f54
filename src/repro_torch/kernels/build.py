"""Build and load the port's hand-written CUDA kernels.

The counterpart of `repro/kernels/runtime.py`. Each `csrc/<name>.cu` is
compiled at first use, on the machine with the card, by one `nvcc` call
into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v \
         -o build/repro_torch/<name>-<hash>.so csrc/<name>.cu

(`-Xptxas -v` only adds the register and spill report to the log.)

The library name carries a hash of the source and the flags, so an edited
kernel is rebuilt and an unchanged one is reused. `build()` starts one
`nvcc` per source, all together, and waits for them, and keeps nvcc's
output beside each library (`<name>-<hash>.log`), so that the ptxas
report is there for a library built earlier too. `load()` opens a library
with `ctypes` and declares its entry points.

There is no switch between kernel and plain version here: a wrapper takes
the plain PyTorch version only for tensors that lie on the CPU, and for a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))

_LIBS: dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    """Where the library built from `csrc/<name>.cu` lives: the name
    carries a hash of the source bytes and the compiler flags."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under /usr/local/cuda): the "
        "repro_torch CUDA kernels are compiled at first use on a machine "
        "with the CUDA toolkit")


def build(names: tuple[str, ...] = SOURCES) -> dict[str, dict]:
    """Compile every named source that has no library yet, one `nvcc` per
    source, all started together. Returns {name: {"seconds", "cached",
    "log"}}; `log` holds nvcc's output (ptxas register/spill report), for
    a cached library the output of the build that made it.
    Raises RuntimeError with nvcc's output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report, procs = {}, {}
    start = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            report[name] = {"seconds": 0.0, "cached": True,
                            "log": log.read_text() if log.exists() else ""}
            continue
        tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - start,
                        "cached": False, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(name: str, signatures: dict[str, tuple]) -> ctypes.CDLL:
    """Open (building first if needed) the library of `csrc/<name>.cu` and
    declare `signatures`: {function: (restype, [argtypes])}. Pass
    ctypes.c_void_p for every pointer and for the stream."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    for fn, (restype, argtypes) in signatures.items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
