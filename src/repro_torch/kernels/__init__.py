"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each kernel package has:
  ops.py — the wrapper: on a CUDA tensor it checks device, dtype, shape
           and contiguity, allocates the output, launches the kernel on
           torch's current stream and counts the launch; on a CPU tensor
           it runs the plain version. Any other device raises.
  ref.py — the plain PyTorch version (the oracle the kernel is held to)

On a meta tensor a wrapper returns an empty result of its plain
version's shape and dtype, with no launch and no count: the dry run
(launch/step_analysis.py) runs whole steps on the meta device. While an
analysis is active, a wrapper called on a meta or CUDA tensor reports
its work (`reported`); on a CPU tensor the plain version's own tensor ops
are counted as they run.

The CUDA sources live in repro_torch/csrc/ (*.cu, with shared kernel
bodies in *.cuh headers). The first kernel call builds
them with nvcc into one shared library with a plain C interface under
build/ at the repository root (one nvcc per source, all started together,
then one link), keyed by a digest of the sources and flags so an edited
source rebuilds, and loads it with ctypes. Nothing here runs at import
time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every kernel entry point in csrc/: (argtypes, restype)
_SIGNATURES = {
    "paged_decode_bf16": ([_P] * 6 + [_I] * 7 + [_P] * 2, _I),
    "paged_decode_int8": ([_P] * 8 + [_I] * 7 + [_P] * 2, _I),
    "topk_topp_mask_f32": ([_P] * 4 + [_I, _I, _P], _I),
    "flash_attention_bf16": ([_P] * 4 + [_I] * 8 + [_P], _I),
    "flash_attention_smem_bytes": ([_I], _I),
    "rglru_scan_f32": ([_P] * 4 + [_I] * 3 + [_P], _I),
    "wkv6_bf16": ([_P] * 7 + [_I] * 4 + [_P], _I),
    "flash_decode_partials": ([_P] * 9 + [_I] * 10 + [_P], _I),
    "flash_decode_smem_bytes": ([_I] * 5, _I),
    "kernel_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc's -Xptxas -v report of the loaded library's build


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build with the "
                           "CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _build(lib_path: Path) -> str:
    nvcc = _nvcc()
    obj_dir = lib_path.with_suffix("")
    obj_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in _sources():
        obj = obj_dir / (src.stem + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, _, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = lib_path.with_name(lib_path.name + f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    return "\n".join(log)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        # headers too: a source's object changes with what it includes
        for src in sorted(CSRC.glob("*.cu*")):
            h.update(src.name.encode())
            h.update(src.read_bytes())
        lib_path = BUILD_DIR / f"libreprokernels-{h.hexdigest()[:16]}.so"
        log_path = lib_path.with_suffix(".log")
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            build_log = _build(lib_path)
            log_path.write_text(build_log)
        elif log_path.exists():
            build_log = log_path.read_text()
        lib = ctypes.CDLL(str(lib_path))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
        return lib


def check_launch(code: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if code != 0:
        msg = library().kernel_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def check_tensors(name: str, *tensors) -> None:
    """Device and layout checks shared by the wrappers: every tensor on the
    first one's device, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input {tuple(t.shape)}")


class _Analysis:
    """The hook of the step analysis (launch/step_analysis.py). While
    `sink` is set, a kernel op called on a meta or CUDA tensor runs with
    `quiet` raised, so the analysis leaves the tensor ops of its body
    uncounted (its output and workspace allocations, its alignment
    copies: the meta branch has none of them), and then hands the sink
    (flops, bytes read and written, its result). With no sink an op pays
    one check."""
    sink = None
    quiet = 0


ANALYSIS = _Analysis()


def nbytes(*tensors) -> int:
    """The bytes of the tensors given (None and numbers skipped)."""
    import torch
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def reported(work):
    """Decorator of a kernel op: work(*args, **kwargs) gives (flops,
    bytes) at the call's shapes: the products its plain version computes
    (the count torch.utils.flop_counter.FlopCounterMode gives of it on
    the CPU) and the bytes the kernel reads and writes."""
    def wrap(op):
        @functools.wraps(op)
        def call(*args, **kwargs):
            sink = ANALYSIS.sink
            if sink is None or args[0].device.type == "cpu":
                return op(*args, **kwargs)
            ANALYSIS.quiet += 1
            try:
                out = op(*args, **kwargs)
            finally:
                ANALYSIS.quiet -= 1
            sink(*work(*args, **kwargs), out)
            return out
        return call
    return wrap
