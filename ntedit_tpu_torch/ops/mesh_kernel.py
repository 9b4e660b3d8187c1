"""The reduce of the mesh collectives: CUDA kernel wrappers and their plain
torch versions.

* ``or_rows(rows)``: int32 [D, m] (uint32 filter words held as int32) ->
  int32 [m], the bitwise OR of the D rows;
* ``sat_add_rows(rows)``: uint8 [D, m] (counters) -> uint8 [m],
  ``min(sum, 255)`` per byte.

They are the local step of ``parallel/mesh.py``'s ``ring_or`` and
``saturating_add_allreduce``: each rank reduces the D pieces an
all_to_all brought it.  On a CUDA tensor a wrapper launches
csrc/mesh_kernel.cu (built with nvcc at first use, see utils/build.py) on
the current stream, does not synchronise, and raises when it cannot; on a
CPU tensor it runs its plain version.  See the note in the .cu source.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from ntedit_tpu_torch.ops import gate_kernel
from ntedit_tpu_torch.utils.build import build_library

SOURCE = os.path.join(gate_kernel.CSRC, "mesh_kernel.cu")
OP_CODE = {"or": 0, "sat_add": 1}


def or_rows_plain(rows: torch.Tensor) -> torch.Tensor:
    """The OR of the rows in plain torch, on any device: a loop of ``|=``."""
    out = rows[0].clone()
    for row in rows[1:]:
        out |= row
    return out


def sat_add_rows_plain(rows: torch.Tensor) -> torch.Tensor:
    """The saturating sum of the rows in plain torch, on any device."""
    return rows.sum(0, dtype=torch.int32).clamp_(max=255).to(torch.uint8)


_lib = None
_lib_lock = threading.Lock()


def build(force: bool = False) -> str:
    """Compile the kernel (once per content of its source); returns the
    .so path."""
    return build_library("mesh_kernel", SOURCE, gate_kernel._command, force=force)


def build_log() -> str:
    """What nvcc printed when it built the library (``-Xptxas -v``)."""
    with open(build() + ".log") as f:
        return f.read()


def open_library(path: str):
    """Load a build of the kernel and declare its C interface."""
    lib = ctypes.CDLL(path)
    lib.ntm_reduce_rows.restype = ctypes.c_int
    lib.ntm_reduce_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,  # rows, D, stride, bytes
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,                 # op, out, stream
    ]
    lib.ntm_occupancy.restype = ctypes.c_int
    lib.ntm_occupancy.argtypes = [ctypes.c_int]
    lib.ntm_error_string.restype = ctypes.c_char_p
    lib.ntm_error_string.argtypes = [ctypes.c_int]
    return lib


def load_library():
    """The kernel's ctypes library, built at first use.  Raises when it
    cannot be built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = open_library(build())
        return _lib


def _reduce(rows: torch.Tensor, op: str, dtype, fn, plain) -> torch.Tensor:
    if rows.dtype != dtype or rows.dim() != 2 or rows.shape[0] < 1:
        raise ValueError(f"{fn.__name__} takes {dtype} rows [D >= 1, m], got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if rows.device.type == "cpu":
        return plain(rows)
    lib = load_library()
    if rows.device.type != "cuda" or (rows.shape[1] and rows.stride(1) != 1):
        raise ValueError(f"{fn.__name__} needs rows on a CUDA device, each contiguous "
                         f"(got {rows.device}, strides {rows.stride()})")
    out = torch.empty(rows.shape[1], dtype=dtype, device=rows.device)
    if not rows.shape[1]:
        return out
    elt = rows.element_size()
    with torch.cuda.device(rows.device):
        rc = lib.ntm_reduce_rows(rows.data_ptr(), rows.shape[0], rows.stride(0) * elt,
                                 rows.shape[1] * elt, OP_CODE[op], out.data_ptr(),
                                 torch.cuda.current_stream(rows.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: "
                           f"{lib.ntm_error_string(rc).decode()}")
    with _count_lock:
        fn.launches += 1
    return out


def or_rows(rows: torch.Tensor) -> torch.Tensor:
    """int32 [m]: the bitwise OR of the D rows of ``rows`` (int32 [D, m])."""
    return _reduce(rows, "or", torch.int32, or_rows, or_rows_plain)


def sat_add_rows(rows: torch.Tensor) -> torch.Tensor:
    """uint8 [m]: ``min(sum, 255)`` of the D rows of ``rows`` (uint8 [D, m])."""
    return _reduce(rows, "sat_add", torch.uint8, sat_add_rows, sat_add_rows_plain)


_count_lock = threading.Lock()
or_rows.launches = 0  # kernel launches since the last reset
sat_add_rows.launches = 0
KERNELS = (or_rows, sat_add_rows)

OCCUPANCY_FORMS = ("or_rows_16", "or_rows_4", "or_rows_1",
                   "sat_add_rows_16", "sat_add_rows_4", "sat_add_rows_1")


def occupancy() -> dict:
    """Resident blocks per SM of each kernel form (op and vector bytes) on
    the current card; negative on error."""
    lib = load_library()
    return {name: lib.ntm_occupancy(i) for i, name in enumerate(OCCUPANCY_FORMS)}
