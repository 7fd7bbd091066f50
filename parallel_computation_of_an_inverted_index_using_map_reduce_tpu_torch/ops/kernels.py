"""The engine's four hand-written CUDA kernels, their plain versions and
their build.

- :func:`unique_mask_count` (``csrc/unique_mask_count.cu``) — the reduce
  phase's per-(term, doc) dedup as one pass over the sorted keys:
  first-occurrence mask, validity mask and the unique count.
- :func:`bucket_histogram` (``csrc/bucket_histogram.cu``) — per-partition
  pair counts for the ``--skew`` statistics (utils/stats.py).
- :func:`merge_sorted_rows` (``csrc/merge_rows.cu``) — the streaming
  all-device engine's fold of a sorted-unique window of word rows into
  its sorted-unique accumulator, a merge path with no sort.
- :func:`tokenize_window` (``csrc/tokenize_window.cu``) — the all-device
  plans' tokenizer: a byte window to its token rows in one read of the
  bytes.

Each wrapper runs the kernel for a CUDA tensor and the plain PyTorch
version (``*_plain``; for the tokenizer ``device_tokenizer.tokenize_groups``)
for a CPU tensor; any other device raises.  There
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
_PP = ctypes.POINTER(ctypes.c_void_p)
_SPECS = {
    "unique_mask_count": ("mri_unique_mask_count", [_VP, _LL, _I, _VP, _VP, _I, _VP]),
    "bucket_histogram": ("mri_bucket_histogram", [_VP, _LL, _I, _VP, _I, _VP]),
    "merge_rows": ("mri_merge_sorted_rows", [_PP, _LL, _PP, _LL, _I, _I, _VP, _VP, _PP, _LL,
                                             _VP, _VP, _LL, _I, _VP]),
    "tokenize_window": ("mri_tokenize_window", [_VP, _LL, _VP, _LL, _VP, _I, _I, _I, _PP, _LL,
                                                _VP, _VP, _VP, _LL, _I, _VP]),
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


# ---------------------------------------------------------------------------
# merge_sorted_rows
# ---------------------------------------------------------------------------

# the kernel's smallest tile (csrc/merge_rows.cu: 256 threads, one
# diagonal each), which bounds its tile count and so its scratch
_MERGE_MIN_TILE = 256
_MERGE_MAX_COLS = 64


def merge_sorted_rows_plain(acc, window, *, cap: int, live_groups: int) -> tuple:
    """Plain version: the sort-based fold of ``ops/device_streaming.py``
    (concatenate, radix-sort, dedup, compact into ``cap`` rows), which
    takes rows in any order."""
    from .device_streaming import _merge_unique_rows

    return _merge_unique_rows(acc, window, cap=cap, live_groups=live_groups)


def _check_columns(cols, name: str) -> int:
    rows = cols[0].shape[0]
    for c in cols:
        if c.dtype != torch.int32 or c.dim() != 1 or c.shape[0] != rows or not c.is_contiguous():
            raise ValueError(f"merge_sorted_rows: {name} needs contiguous 1-D int32 columns "
                             f"of one length, got {c.dtype} {tuple(c.shape)}")
    return rows


def merge_sorted_rows(acc, window, acc_count: torch.Tensor, win_count: torch.Tensor, *,
                      cap: int, live_groups: int) -> tuple:
    """Merge a window's sorted-unique word rows into the sorted-unique
    accumulator: ``(rows, count)``, ``rows`` a tuple of ``cap``-long
    int32 columns (the merged rows first, a row the two share once, then
    INT32_MAX) and ``count`` their int32 0-d count on the card.

    ``acc`` and ``window`` are tuples of ``2 * groups + 1`` columns
    (group pairs, then the doc), each sorted lexicographically over the
    first ``live_groups`` pairs and the doc with its valid rows first;
    the later pairs are 0 on valid rows.  ``acc_count`` and ``win_count``
    are their valid rows, int32 scalars read on the card only, so the
    host never waits.  ``cap`` may exceed the accumulator's length.
    """
    if len(acc) != len(window) or not 3 <= len(acc) <= _MERGE_MAX_COLS or len(acc) % 2 == 0:
        raise ValueError(f"merge_sorted_rows: need two tuples of one odd column count in "
                         f"[3, {_MERGE_MAX_COLS}], got {len(acc)} and {len(window)}")
    if not 1 <= live_groups <= len(acc) // 2:
        raise ValueError(f"merge_sorted_rows: live_groups {live_groups} not in "
                         f"[1, {len(acc) // 2}]")
    if cap < 0:
        raise ValueError(f"merge_sorted_rows: cap {cap} is negative")
    for t in (*acc, *window, acc_count, win_count):
        _check_device(t, "merge_sorted_rows")
        if t.device != acc[0].device:
            raise ValueError(f"merge_sorted_rows: tensors on {t.device} and {acc[0].device}")
    a_cap, b_cap = _check_columns(acc, "acc"), _check_columns(window, "window")
    for t in (acc_count, win_count):
        if t.dtype != torch.int32 or t.numel() != 1:
            raise ValueError(f"merge_sorted_rows: counts must be int32 scalars, got "
                             f"{t.dtype} {tuple(t.shape)}")
    dev = acc[0].device
    if dev.type == "cpu":
        return merge_sorted_rows_plain(acc, window, cap=cap, live_groups=live_groups)
    ncols = len(acc)
    rows = torch.empty((ncols, cap), dtype=torch.int32, device=dev).unbind(0)
    count = torch.empty((), dtype=torch.int32, device=dev)
    scratch_len = 2 * -(-(a_cap + b_cap) // _MERGE_MIN_TILE) + 1
    scratch = torch.empty(scratch_len, dtype=torch.int64, device=dev)
    cols = ctypes.c_void_p * ncols
    _launch("merge_rows", cols(*(a.data_ptr() for a in acc)), a_cap,
            cols(*(w.data_ptr() for w in window)), b_cap, ncols, live_groups,
            acc_count.data_ptr(), win_count.data_ptr(),
            cols(*(r.data_ptr() for r in rows)), cap, count.data_ptr(),
            scratch.data_ptr(), scratch_len, *_stream_args(acc[0]))
    merge_sorted_rows.launches += 1
    return rows, count


merge_sorted_rows.launches = 0


# ---------------------------------------------------------------------------
# tokenize_window
# ---------------------------------------------------------------------------

# bytes a block of csrc/tokenize_window.cu takes, which sizes its scratch
_TOKENIZE_TILE = 8192
# the widest row the kernel packs: device_tokenize_width's bound (config.py)
_TOKENIZE_MAX_WIDTH = 296


def tokenize_window(data, doc_ends, doc_id_values, *, width: int, tok_cap: int,
                    num_docs: int, sort_cols: int | None = None) -> tuple:
    """A byte window's token rows: ``(groups, doc_col, max_word_len,
    num_tokens)``, exactly what its plain version,
    ``device_tokenizer.tokenize_groups`` (the byte-scale PyTorch chain),
    returns.

    ``data``: uint8 bytes; ``doc_ends``: ascending int32 document ends
    (ends equal to the byte count are padding); ``doc_id_values``: int32
    ids, the first ``num_docs`` used; each 1-D and contiguous, all on one
    device.  ``groups`` holds ``num_groups_for(width)`` (hi, lo) pairs of
    ``tok_cap`` int32 rows, the pairs past ``live_groups_for(sort_cols,
    width)`` one zero column; ``max_word_len`` and ``num_tokens`` are
    int32 scalars on the card, so the host never waits.
    """
    from .device_tokenizer import live_groups_for, num_groups_for, tokenize_groups

    tensors = (("data", data, torch.uint8), ("doc_ends", doc_ends, torch.int32),
               ("doc_id_values", doc_id_values, torch.int32))
    for name, t, dtype in tensors:
        if t.device != data.device:
            raise ValueError(f"tokenize_window: tensors on {t.device} and {data.device}")
        _check_device(t, "tokenize_window")
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"tokenize_window: {name} needs a contiguous 1-D {dtype} tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    n = data.shape[0]
    if width % 4 or not 4 <= width <= _TOKENIZE_MAX_WIDTH:
        raise ValueError(f"tokenize_window: width {width} is not a multiple of 4 in "
                         f"[4, {_TOKENIZE_MAX_WIDTH}]")
    if not 0 <= tok_cap < 2**31 or n >= 2**31:
        raise ValueError(f"tokenize_window: tok_cap {tok_cap} or {n} bytes out of int32 range")
    if not 1 <= num_docs <= doc_id_values.shape[0]:
        raise ValueError(f"tokenize_window: num_docs {num_docs} not in "
                         f"[1, {doc_id_values.shape[0]}]")
    if n == 0 and tok_cap:
        raise ValueError("tokenize_window: an empty window has no token slots: tok_cap must be 0")
    if data.device.type == "cpu":
        return tokenize_groups(data, doc_ends, doc_id_values, width=width, tok_cap=tok_cap,
                               num_docs=num_docs, sort_cols=sort_cols)
    dev = data.device
    live = live_groups_for(sort_cols, width)
    ncols = 2 * live + 1
    cols = torch.empty((ncols, tok_cap), dtype=torch.int32, device=dev).unbind(0)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    scratch_len = max(-(-n // _TOKENIZE_TILE), 1)
    scratch = torch.empty(scratch_len, dtype=torch.int64, device=dev)
    ptrs = ctypes.c_void_p * ncols
    _launch("tokenize_window", data.data_ptr(), n, doc_ends.data_ptr(), doc_ends.shape[0],
            doc_id_values.data_ptr(), num_docs, width, live, ptrs(*(c.data_ptr() for c in cols)),
            tok_cap, counts[0].data_ptr(), counts[1].data_ptr(), scratch.data_ptr(), scratch_len,
            *_stream_args(data))
    tokenize_window.launches += 1
    groups = [(cols[2 * g], cols[2 * g + 1]) for g in range(live)]
    if live < num_groups_for(width):
        zero = torch.zeros(tok_cap, dtype=torch.int32, device=dev)
        groups.extend((zero, zero) for _ in range(num_groups_for(width) - live))
    return tuple(groups), cols[-1], counts[0], counts[1]


tokenize_window.launches = 0


def reset_launch_counts() -> None:
    unique_mask_count.launches = 0
    bucket_histogram.launches = 0
    merge_sorted_rows.launches = 0
    tokenize_window.launches = 0
