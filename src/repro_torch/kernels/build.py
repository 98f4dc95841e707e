"""Build and load the CUDA C++ kernels (plain C interface, ``ctypes``).

Each source in ``repro_torch/csrc/*.cu`` compiles with its own ``nvcc``
into its own shared library, all processes started together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

A source may export several launchers (``bucket_topk.cu`` holds
``bucket_hist`` too: ``SOURCE_OF``). Libraries go to
``build/repro_torch_kernels/<hash>/`` at the repository
root, keyed by a hash of every source and header, so an edited kernel
rebuilds and an unchanged one loads in milliseconds. ``nvcc``'s register
and spill report (``-Xptxas -v``) is kept beside each library as
``<name>.log``. Nothing here runs at import time.

A kernel that cannot be built, loaded or launched raises
:class:`KernelError`: a device fault, which the serving engines' quarantine
boundaries re-raise instead of failing one request for it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

class KernelError(RuntimeError):
    """A CUDA kernel did not build, load or launch. Never attributable to
    one request: the engines propagate it out of ``step_serve()``."""


_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, object] = {}

# C signature of each kernel's launcher: every pointer and the stream are
# c_void_p (a plain int would be cut to 32 bits), sizes are c_int / c_int64.
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SIGNATURES = {
    "collision_paged": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _P],
    "bucket_hist": [_P, _P, _I, _I, _I, _I, _I, _P],
    "bucket_topk": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "rerank_topk_paged": [_P] * 13 + [_I] * 14 + [_P],
    "gather_rows_paged": [_P] * 10 + [_L, _L] + [_I] * 11 + [_P],
    "bucket_count": [_P] * 4 + [_I] * 12 + [_P],
    "gather_rows_tiered": [_P] * 9 + [_I] * 9 + [_P],
}
# launcher → the source (csrc/<source>.cu, lib<source>.so) exporting it
SOURCE_OF = {name: name for name in SIGNATURES}
SOURCE_OF["bucket_hist"] = "bucket_topk"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelError("nvcc not found: the CUDA kernels build only on a "
                      "machine with the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every kernel whose library is missing (in parallel) and
    return the build directory. Raises ``KernelError`` with nvcc's output
    on failure."""
    out_dir = BUILD_ROOT / _source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in sorted(set(SOURCE_OF.values())):
        lib = out_dir / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        log = open(out_dir / f"{name}.log", "w")
        cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       log, tmp, lib)
    failed = []
    for name, (proc, log, tmp, lib) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(name)
    if failed:
        logs = "\n".join((out_dir / f"{n}.log").read_text() for n in failed)
        raise KernelError(f"nvcc failed for {failed}:\n{logs}")
    return out_dir


def launcher(name: str):
    """The C function ``<name>_launch`` with its signature set (building
    every library on first use)."""
    if name not in _FNS:
        src = SOURCE_OF[name]
        try:
            if src not in _LIBS:
                _LIBS[src] = ctypes.CDLL(str(build_all() / f"lib{src}.so"))
            fn = getattr(_LIBS[src], f"{name}_launch")
        except (OSError, AttributeError) as exc:
            raise KernelError(f"CUDA kernel {name}: cannot load "
                              f"lib{src}.so: {exc}") from exc
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def ptxas_report(source: str) -> Dict[str, Dict[str, int]]:
    """Registers, static shared memory and spill bytes of each kernel in
    ``csrc/<source>.cu``, read from nvcc's ``-Xptxas -v`` log beside its
    library: {mangled kernel name: {"registers", "smem_static",
    "spill_stores", "spill_loads"}}."""
    import re
    log = (build_all() / f"{source}.log").read_text()
    out: Dict[str, Dict[str, int]] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem_static"] = int(sm.group(1)) if sm else 0
    return out


def launch(name: str, *args) -> None:
    """Call ``<name>_launch(*args, stream)`` on the current CUDA stream and
    raise ``KernelError`` if the launch was refused (``cudaGetLastError``
    != 0)."""
    stream = torch.cuda.current_stream().cuda_stream
    err = launcher(name)(*args, stream)
    if err != 0:
        raise KernelError(f"CUDA kernel {name} failed to launch: "
                          f"cudaError {err}")


# shared memory one block may use on Hopper (227 KB)
MAX_SMEM = 227 << 10


@functools.lru_cache(maxsize=8)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(
        device.index or 0).multi_processor_count


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """A tensor's device address for a launcher; None is a null pointer."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Wrapper-side validation: every tensor on one CUDA device and
    contiguous (the kernels compute their own offsets)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
