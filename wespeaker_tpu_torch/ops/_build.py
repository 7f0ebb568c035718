"""Build the CUDA kernels of `csrc/` at first use and bind them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled by nvcc alone
(no PyTorch headers) into `build/lib<name>-<hash>.so` under the repo root,
for `sm_90a` (Hopper). The hash covers the sources, the shared headers and
the flags, so an edited kernel is rebuilt and a stale library is never
loaded. Several kernels build in parallel: one nvcc process per source,
all started together.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
KERNELS = ("se_block", "mfa_astp", "mfa_astp_train", "cam_block",
           "inv_bottleneck", "conv_dw_pack", "pooling")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built on the machine with the card")


def lib_path(name: str) -> Path:
    if name not in KERNELS:
        raise KeyError(f"unknown kernel library {name}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every library in `names` that is not built yet, all nvcc
    processes at once. Returns {name: compiler output} (ptxas register and
    shared-memory report) for those it compiled; raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees
            # a half-written library
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library `name`, compiling it first if needed."""
    path = lib_path(name)
    if not path.exists():
        build((name,))
    lib = ctypes.CDLL(str(path))
    lib.ws_error_string.argtypes = [ctypes.c_int]
    lib.ws_error_string.restype = ctypes.c_char_p
    return lib


GEMM_ROUTES = ("gemm_sm90", "gemm_tn_sm90", "wmma", "fma")


def gemm_routes(name: str) -> Dict[str, int]:
    """The GEMM launches library `name` (mfa_astp or mfa_astp_train) has
    made so far in this process, by route, as the library counts them
    where it launches each (csrc/common.cuh::gemm_route_counts)."""
    lib = load(name)
    out = (ctypes.c_longlong * len(GEMM_ROUTES))()
    lib.ws_gemm_route_counts.argtypes = [ctypes.c_void_p]
    lib.ws_gemm_route_counts(out)
    return dict(zip(GEMM_ROUTES, out))


def pointers(tensors) -> list:
    """Device addresses of contiguous tensors, as the kernels read them
    (16-byte vector loads)."""
    out = []
    for v in tensors:
        if not v.is_contiguous() or v.data_ptr() % 16:
            raise ValueError("kernel operands must be contiguous and "
                             "16-byte aligned")
        out.append(v.data_ptr())
    return out


def on_device(fn):
    """Run the launcher `fn` with the device of its first CUDA tensor
    argument (or of a list's first tensor) current. The C entry points
    launch on the current device: the shared-memory opt-in
    (cudaFuncSetAttribute), the launch, the error check and the SM count
    (csrc/common.cuh::sm_count) all act on it, so a tensor on cuda:1
    launched while cuda:0 is current would fail. CPU tensors pass
    through."""
    import torch

    @functools.wraps(fn)
    def launch(*args, **kwargs):
        dev = None
        for a in args:
            t = a[0] if isinstance(a, (list, tuple)) and a else a
            if isinstance(t, torch.Tensor):
                dev = t.device
                break
        if dev is None or dev.type != "cuda":
            return fn(*args, **kwargs)
        with torch.cuda.device(dev):
            return fn(*args, **kwargs)

    return launch


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({lib.ws_error_string(rc).decode()})")
