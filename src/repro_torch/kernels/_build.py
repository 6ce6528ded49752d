"""Build, load and launch the hand-written CUDA kernels.

The sources in `csrc/` compile for `sm_90a` with `nvcc` into one shared
library with a plain C interface, loaded with `ctypes`. Each source is
compiled by its own `nvcc` process, all started together, and the objects
are linked once. The library lands in `build/kernels-<hash>/` at the root of
the checkout (listed in `.gitignore`), keyed by a hash of the sources and
flags, so a checkout builds on first use and reuses the result afterwards.
Nothing here runs when the module is imported.

`LAUNCHES` counts, per kernel, the launches its wrapper made; a wrapper adds
one right after its kernel was accepted and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
LIB_NAME = "librepro_torch_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

KERNELS = ("coverage_gain", "coverage_gain_split", "bit_matvec", "bit_matvec_split",
           "clause_match", "tier_match",
           "partition_gain", "partition_gain_split", "sparse_gain", "flash_attention", "flash_decode",
           "flash_prefill", "flash_attention_short", "flash_backward", "flash_backward_tc",
           "flash_backward_short", "segment_sum", "segment_sum_stream")
LAUNCHES: dict[str, int] = {k: 0 for k in KERNELS}
MAX_GRID_Z = 65535   # gridDim.z at most: a wrapper launches a larger batch in slices

_P, _I64, _INT, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
_PINT = ctypes.POINTER(ctypes.c_int)
_PI64 = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "coverage_gain_launch": [_P, _P, _P, _I64, _I64, _INT, _INT, _P],
    "coverage_gain_split_launch": [_P, _P, _P, _I64, _I64, _INT, _INT, _P],
    "bit_matvec_launch": [_P, _P, _P, _I64, _I64, _I64, _INT, _INT, _P],
    "bit_matvec_split_launch": [_P, _P, _P, _I64, _I64, _I64, _INT, _INT, _P],
    "clause_match_launch": [_P] * 5 + [_I64] * 3 + [_INT, _INT, _P],
    "clause_tokens_launch": [_P] * 3 + [_I64] * 2 + [_INT, _P],
    "tier_match_launch": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _INT, _P],
    "partition_gain_launch": [_P, _P, _P, _P, _I64, _I64, _I64, _INT, _INT, _P],
    "partition_gain_split_launch": [_P, _P, _P, _P, _I64, _I64, _I64, _INT, _INT, _P],
    "sparse_gain_launch": [_P, _P, _P, _I64, _I64, _I64, _INT, _INT, _P],
    "flash_attention_launch": [_P] * 4 + [_I64] * 17 + [_F32, _F32, _INT, _INT, _I64, _P],
    "flash_decode_launch": [_P] * 5 + [_I64] * 16 + [_INT, _F32, _INT, _INT, _INT, _P],
    "flash_decode_ctas_per_sm": [_I64, _INT, _INT, _PINT],
    "flash_prefill_launch": [_P] * 5 + [_I64] * 17 + [_F32, _INT, _P],
    "flash_attention_short_launch": [_P] * 4 + [_I64] * 6 + [_PI64] + [_I64] * 3
                                    + [_F32, _F32, _INT, _INT, _INT] + [_I64] * 5 + [_P],
    "flash_backward_launch": [_P] * 10 + [_I64] * 6 + [_PI64, _I64, _I64, _F32,
                                                       _F32, _INT, _INT, _P],
    "flash_backward_tc_launch": [_P] * 10 + [_I64] * 5 + [_PI64, _I64, _F32, _INT, _P],
    "flash_backward_short_launch": [_P] * 8 + [_I64] * 6 + [_PI64, _INT] + [_I64] * 7
                                   + [_F32, _F32, _INT, _INT, _I64, _P],
    "segment_sum_launch": [_P] * 5 + [_I64, _I64, _INT, _P],
    "segment_sum_stream_launch": [_P] * 5 + [_I64, _P],
    "empty_launch": [_P],
}

_lib: ctypes.CDLL | None = None
build_info: dict = {}   # seconds, path, compiler log of the build this process did or found


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(files: list[Path]) -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile `csrc/*.cu` (one nvcc each, in parallel) and link the library,
    unless a build of the same sources already exists."""
    sources = sorted(CSRC.glob("*.cu"))
    out_dir = BUILD_ROOT / f"kernels-{_digest(sources + sorted(CSRC.glob('*.cuh')))}"
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        build_info.update(seconds=0.0, path=str(lib_path), log="(cached)")
        return lib_path
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="tmp-kernels-", dir=BUILD_ROOT))
    procs: list[tuple[Path, subprocess.Popen]] = []
    try:
        for src in sources:
            cmd = [nvcc, *ARCH, *FLAGS, "-c", str(src),
                   "-o", str(tmp / (src.stem + ".o"))]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp / LIB_NAME),
             *(str(tmp / (s.stem + ".o")) for s in sources)],
            capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}{link.stderr}")
        (tmp / "build.log").write_text(log)
        try:
            tmp.rename(out_dir)
        except OSError:          # another process finished the same build first
            if not lib_path.exists():
                raise
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    build_info.update(seconds=time.perf_counter() - t0, path=str(lib_path),
                      log=log)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.rt_error_string.argtypes = [ctypes.c_int]
        handle.rt_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def _call(name: str, device: torch.device, call) -> None:
    """`call(lib, stream)` on `device`'s current stream: under that device's
    context only when it is not the current device already (a launch goes
    to the current device), with the stream read as the raw handle the
    launch takes. Raise if the launch was refused."""
    handle = _lib if _lib is not None else lib()
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        code = call(handle, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            code = call(handle, torch._C._cuda_getCurrentRawStream(index))
    if code != 0:
        msg = handle.rt_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (code {code})")


def launch(name: str, device: torch.device, call) -> None:
    """Run `call(lib, stream)` for kernel `name` on `device`'s current stream;
    raise if the launch was refused, else count it."""
    _call(name, device, call)
    LAUNCHES[name] += 1


def launch_floor(device: torch.device) -> None:
    """Launch an empty kernel the way `launch` launches a wrapper's (not
    counted): what a one-row gain call costs at the least."""
    _call("empty", device, lambda lib, stream: lib.empty_launch(stream))


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
            device: torch.device | None = None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and rank
    `ndim` (on `device`, when given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor (or every operand on "
                         f"the CPU), got device {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have rank {ndim}, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def output(out: torch.Tensor | None, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """A new contiguous `dtype` tensor of `shape` on `device`, or `out`
    once it is checked to be one (a kernel writes it whole, densely)."""
    if out is None:
        return torch.empty(shape, dtype=dtype, device=device)
    require(out, "out", dtype, len(shape), device)
    if tuple(out.shape) != shape:
        raise ValueError(f"out has shape {tuple(out.shape)}, need {shape}")
    return out


def aligned16(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def on_cpu(*ts: torch.Tensor | None) -> bool:
    """True when every given tensor lies on the CPU (the plain path)."""
    return all(t is None or t.device.type == "cpu" for t in ts)


def on_meta(*ts: torch.Tensor | None) -> bool:
    """True when every given tensor is a meta tensor: the dry run
    (`launch.dryrun`) propagates shapes through the plain version. Never
    true for a CPU or CUDA tensor."""
    return all(t is None or t.device.type == "meta" for t in ts)
