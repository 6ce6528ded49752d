"""Build one CUDA source into its own shared library for a probe script.

    lib = nvcc_lib.load(Path("kernel.cu"), "tag")

Compiles with the port's `nvcc` flags for `sm_90a` (`repro_torch.kernels
._build`) and the port's `csrc/` on the include path, into
`build/probe-<tag>-<hash>/` (nvcc's output, ptxas's register and spill
lines among it, beside it as `build.log`), and loads the result with
ctypes. The caller sets each function's `argtypes` and `restype`.
"""
from __future__ import annotations

import ctypes
import hashlib
import subprocess
from pathlib import Path

from repro_torch.kernels import _build


def load(src: Path, tag: str) -> ctypes.CDLL:
    text = src.read_bytes()
    h = hashlib.sha256(text + " ".join(_build.ARCH + _build.FLAGS).encode())
    out_dir = _build.BUILD_ROOT / f"probe-{tag}-{h.hexdigest()[:16]}"
    lib = out_dir / f"lib{tag}.so"
    if not lib.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.ARCH, *_build.FLAGS, "-shared",
               "-I", str(_build.CSRC), "-o", str(lib), str(src)]
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{done.stdout}{done.stderr}")
        (out_dir / "build.log").write_text(done.stdout + done.stderr)
    return ctypes.CDLL(str(lib))
