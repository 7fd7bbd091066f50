"""The engine's two hand-written CUDA kernels, their plain versions and
their build.

- :func:`unique_mask_count` (``csrc/unique_mask_count.cu``) — the reduce
  phase's per-(term, doc) dedup as one pass over the sorted keys:
  first-occurrence mask, validity mask and the unique count.
- :func:`bucket_histogram` (``csrc/bucket_histogram.cu``) — per-partition
  pair counts for the ``--skew`` statistics (utils/stats.py).

Each wrapper runs the kernel for a CUDA tensor and the plain PyTorch
version (``*_plain``) for a CPU tensor; any other device raises.  There
is no fallback from one to the other.  ``wrapper.launches`` counts the
kernel launches, so a run can show that it went through the kernel.

The sources are compiled with ``nvcc`` for ``sm_90a`` into
``csrc/_build/`` (one shared library per source, named by the source's
hash, all compiled in parallel) at the first launch or at an explicit
:func:`build`, and bound with ``ctypes`` through a plain C interface.
Nothing is compiled or loaded at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = _CSRC / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_BUCKETS = 128

# (source stem, C symbol, argtypes)
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SPECS = {
    "unique_mask_count": ("mri_unique_mask_count", [_VP, _LL, _I, _VP, _VP, _I, _VP]),
    "bucket_histogram": ("mri_bucket_histogram", [_VP, _LL, _I, _VP, _I, _VP]),
}
_libs: dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise KernelBuildError("nvcc not found on PATH or under CUDA_HOME/bin")


def _lib_path(stem: str) -> Path:
    digest = hashlib.sha256((_CSRC / f"{stem}.cu").read_bytes()
                            + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
    return _BUILD_DIR / f"libmri_{stem}_{digest}.so"


def build() -> dict:
    """Compile every kernel source not yet built (one ``nvcc`` each, all
    started together) and load them.  Returns ``{"seconds": wall time,
    "ptxas": {stem: nvcc's register/shared-memory report}}``."""
    t0 = time.perf_counter()
    ptxas: dict[str, str] = {}
    with _build_lock:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = [s for s in _SPECS if s not in _libs]
        procs = {}
        for stem in todo:
            out = _lib_path(stem)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            procs[stem] = (tmp, subprocess.Popen(
                [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{stem}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for stem, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            ptxas[stem] = log.strip()
            if proc.returncode != 0:
                failed.append(f"{stem}.cu (nvcc exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, _lib_path(stem))
        if failed:
            raise KernelBuildError("kernel build failed: " + "\n".join(failed))
        for stem in todo:
            lib = ctypes.CDLL(str(_lib_path(stem)))
            symbol, argtypes = _SPECS[stem]
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            err = getattr(lib, f"{symbol}_error")
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            _libs[stem] = lib
    return {"seconds": time.perf_counter() - t0, "ptxas": ptxas}


def _launch(stem: str, *args) -> None:
    if stem not in _libs:
        build()
    lib = _libs[stem]
    symbol = _SPECS[stem][0]
    code = getattr(lib, symbol)(*args)
    if code != 0:
        msg = getattr(lib, f"{symbol}_error")(code).decode()
        raise RuntimeError(f"{stem} kernel launch failed: CUDA error {code} ({msg})")


def _stream_args(t: torch.Tensor) -> tuple[int, int]:
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def _check_device(t: torch.Tensor, name: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


# ---------------------------------------------------------------------------
# unique_mask_count
# ---------------------------------------------------------------------------


def unique_mask_count_plain(keys: torch.Tensor, valid_limit: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``first_occurrence_mask(k) & (k < valid_limit)``
    and its int32 sum."""
    prev = torch.cat([keys[:1] - 1, keys[:-1]])
    mask = (keys != prev) & (keys < valid_limit)
    return mask, mask.sum(dtype=torch.int32)


def unique_mask_count(keys: torch.Tensor, valid_limit: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """First-occurrence mask + unique count over ascending int32 keys.

    ``mask[i] = (k[i] != k[i-1]) & (k[i] < valid_limit)`` with
    ``k[-1] := k[0] - 1``; returns ``(mask bool (n,), count int32 0-d)``
    on ``keys``' device.  Any ``n``; ``n == 0`` gives ``(empty, 0)``
    without a launch.
    """
    _check_device(keys, "unique_mask_count")
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise ValueError(f"unique_mask_count: need 1-D int32 keys, got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    if not -(2**31) <= valid_limit < 2**31:
        raise ValueError(f"unique_mask_count: valid_limit {valid_limit} is not an int32")
    if keys.device.type == "cpu":
        return unique_mask_count_plain(keys, valid_limit)
    n = keys.shape[0]
    count = torch.zeros((), dtype=torch.int32, device=keys.device)
    mask = torch.empty(n, dtype=torch.bool, device=keys.device)
    if n == 0:
        return mask, count
    keys = keys.contiguous()
    _launch("unique_mask_count", keys.data_ptr(), n, int(valid_limit), mask.data_ptr(),
            count.data_ptr(), *_stream_args(keys))
    unique_mask_count.launches += 1
    return mask, count


unique_mask_count.launches = 0


# ---------------------------------------------------------------------------
# bucket_histogram
# ---------------------------------------------------------------------------


def bucket_histogram_plain(values: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Plain version: one compare-and-sum per bucket (the TPU kernel's
    arithmetic)."""
    return torch.stack([(values == b).sum(dtype=torch.int32)
                        for b in range(num_buckets)])


def bucket_histogram(values: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Count occurrences of each bucket id in ``values``: int32
    ``(num_buckets,)``.  Values outside ``[0, num_buckets)`` (padding)
    are ignored.  Any length; ``1 <= num_buckets <= 128``."""
    _check_device(values, "bucket_histogram")
    if not 1 <= num_buckets <= MAX_BUCKETS:
        raise ValueError(f"num_buckets must be in [1, 128], got {num_buckets}")
    values = values.reshape(-1).to(torch.int32)
    if values.device.type == "cpu":
        return bucket_histogram_plain(values, num_buckets)
    counts = torch.zeros(num_buckets, dtype=torch.int32, device=values.device)
    n = values.shape[0]
    if n == 0:
        return counts
    values = values.contiguous()
    _launch("bucket_histogram", values.data_ptr(), n, num_buckets,
            counts.data_ptr(), *_stream_args(values))
    bucket_histogram.launches += 1
    return counts


bucket_histogram.launches = 0


def reset_launch_counts() -> None:
    unique_mask_count.launches = 0
    bucket_histogram.launches = 0
