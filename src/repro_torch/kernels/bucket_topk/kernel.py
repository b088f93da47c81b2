"""Launchers of the hand-written CUDA kernel ``csrc/bucket_topk.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/bucket_topk/kernel.py``
(``bucket_topk_pallas``). Bound by bytes: x is read once and the residual
written once; the selection is a radix select of the k-th largest |x| in
at most four digit passes over a shared-memory histogram, whatever k is:
one warp a row up to B = 1024, one block a row above (see the source for
the design).

Two entries: :func:`bucket_topk_cuda`, the rows of one tensor, and
:func:`bucket_topk_ef_grouped_cuda`, the error-feedback add fused in
front of the selection for every EF bucket of one packed group buffer,
from one library call: each bucket's rows are ``residual + slice`` (one
f32 add in registers, never stored) and the call writes the new
residuals and the buckets' streams. Its fixed part, an
:class:`EfTopkTable` (a ``BucketTopkEfSeg`` descriptor a bucket: the
geometry, strides and stream offsets, checked once), is built once per
plan; a call fills a copy with the pointers and launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

# B: every multiple of B_QUANTUM up to MAX_B (bucket_scatter's limit too)
B_QUANTUM = 128
MAX_B = 8192


def supported_b(b: int) -> bool:
    return b % B_QUANTUM == 0 and B_QUANTUM <= b <= MAX_B


def require_supported_b(b: int) -> None:
    """Raise, naming the limit, unless the CUDA kernel takes rows of B."""
    if not supported_b(b):
        raise ValueError(f"bucket_topk: the CUDA kernel takes B a multiple "
                         f"of {B_QUANTUM} up to {MAX_B}, got bucket_size={b}")


def bucket_topk_cuda(x: torch.Tensor, k: int):
    """x: (nb, B) f32 CUDA -> (val (nb,k), lidx (nb,k) i32, res (nb,B))."""
    _build.require_cuda("bucket_topk", x)
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"bucket_topk: takes 2-D float32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    nb, b = x.shape
    require_supported_b(b)
    if not 1 <= k <= b:
        raise ValueError(f"bucket_topk: k={k} outside 1 <= k <= B={b}")
    val = torch.empty((nb, k), dtype=x.dtype, device=x.device)
    lidx = torch.empty((nb, k), dtype=torch.int32, device=x.device)
    res = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _build.lib().bucket_topk_f32(
            x.data_ptr(), val.data_ptr(), lidx.data_ptr(), res.data_ptr(),
            nb, b, k, _build.stream(x))
    _build.check(rc, "bucket_topk")
    return val, lidx, res


class _EfSeg(ctypes.Structure):
    """``BucketTopkEfSeg`` of the CUDA source, field for field."""
    _fields_ = [("res", ctypes.c_void_p), ("grad", ctypes.c_void_p),
                ("res_out", ctypes.c_void_p), ("val", ctypes.c_void_p),
                ("lidx", ctypes.c_void_p), ("rank_stride", ctypes.c_longlong),
                ("row_stride", ctypes.c_longlong), ("l", ctypes.c_int),
                ("rows", ctypes.c_int), ("cols", ctypes.c_int),
                ("k", ctypes.c_int), ("b", ctypes.c_int)]


# kMaxEfSegs of the CUDA source: the buckets one launch takes
MAX_EF_SEGS = 48


class EfTopkTable:
    """The fixed part of one grouped EF-add + TopK call: the EF buckets
    ``spans`` ((col_start, cols) each, in order) of a packed (lead, rows,
    group_cols) f32 buffer, rows of B = ``b``, ``k`` kept a row.

    Bucket i's residual is (lead, rows, cols); its streams, val and lidx
    laid out (lead, rows, cols/b, k), lie at ``stream_off[i]`` of the
    step's flat val (f32) and lidx (int32) buffers, one bucket after the
    other from ``stream_start``. The checks, the offsets and the
    descriptor array are made here, once; a call fills a copy of the
    descriptor array with the pointers."""

    def __init__(self, lead: int, rows: int, group_cols: int, spans,
                 b: int, k: int, stream_start: int = 0):
        require_supported_b(b)
        if not 1 <= k <= b:
            raise ValueError(f"bucket_topk: k={k} outside 1 <= k <= B={b}")
        for cs, cols in spans:
            if cols % b or cs < 0 or cs + cols > group_cols:
                raise ValueError(f"bucket_topk: bucket columns [{cs}, "
                                 f"{cs + cols}) of a {group_cols}-column "
                                 f"group are not whole rows of B={b}")
            if lead * rows * (cols // b) >= 2**31:
                raise ValueError("bucket_topk: 2^31 bucket rows or more")
        self.lead, self.rows, self.b, self.k = lead, rows, b, k
        self.buf_shape = (lead, rows, group_cols)
        self.spans = [(int(cs), int(cols)) for cs, cols in spans]
        self.n = len(self.spans)
        self.res_shapes = [(lead, rows, cols) for _, cols in self.spans]
        self.stream_sizes = [lead * rows * (cols // b) * k
                             for _, cols in self.spans]
        self.stream_off = _build.offsets(self.stream_sizes, stream_start)
        self.stream_end = stream_start + sum(self.stream_sizes)
        self.launches = -(-self.n // MAX_EF_SEGS)
        desc = np.zeros(self.n, dtype=np.dtype(_EfSeg))
        desc["rank_stride"] = rows * group_cols
        desc["row_stride"] = group_cols
        desc["l"], desc["rows"], desc["k"], desc["b"] = lead, rows, k, b
        desc["cols"] = [cols for _, cols in self.spans]
        self.desc = desc
        self.grad_bytes = _build.byte_offsets(cs for cs, _ in self.spans)
        self.stream_bytes = _build.byte_offsets(self.stream_off)


def bucket_topk_ef_grouped_cuda(table: EfTopkTable, res, buf: torch.Tensor,
                                val: torch.Tensor,
                                lidx: torch.Tensor) -> tuple[list, int]:
    """One library call for every bucket of ``table``: the new residuals
    (lead, rows, cols) f32, one tensor a bucket, and the number of kernels
    launched (one for every MAX_EF_SEGS buckets). ``res``: the buckets'
    f32 residuals; ``buf``: the packed group buffer; ``val``/``lidx``: the
    step's flat stream buffers, written at the table's offsets."""
    _build.require_cuda("bucket_topk", buf, val, lidx)
    if buf.dtype != torch.float32 or buf.shape != table.buf_shape:
        raise ValueError(f"bucket_topk: the group buffer is {buf.dtype} "
                         f"{tuple(buf.shape)}, the table's float32 "
                         f"{table.buf_shape}")
    if (val.dtype != torch.float32 or lidx.dtype != torch.int32
            or val.dim() != 1 or lidx.dim() != 1
            or min(val.numel(), lidx.numel()) < table.stream_end):
        raise ValueError(f"bucket_topk: the stream buffers are {val.dtype} "
                         f"{tuple(val.shape)} and {lidx.dtype} "
                         f"{tuple(lidx.shape)}, the table needs float32 and "
                         f"int32 of {table.stream_end} entries or more")
    if len(res) != table.n:
        raise ValueError(f"bucket_topk: {len(res)} residuals for "
                         f"{table.n} buckets")
    dev = buf.get_device()
    for r, shape in zip(res, table.res_shapes):
        if (r.dtype != torch.float32 or r.shape != shape
                or not r.is_contiguous() or r.get_device() != dev):
            raise ValueError(f"bucket_topk: a residual is {r.dtype} "
                             f"{tuple(r.shape)} on {r.device}, the table "
                             f"needs a contiguous float32 {shape} on "
                             f"{buf.device}")
    res_ptrs = [r.data_ptr() for r in res]
    if table.b > 1024 and (any(p % 16 for p in res_ptrs)
                           or buf.data_ptr() % 16):
        raise ValueError("bucket_topk: above B = 1024 the residuals and the "
                         "group buffer must start on a 16-byte boundary "
                         "(the kernel loads float4)")
    out = [torch.empty(shape, dtype=torch.float32, device=buf.device)
           for shape in table.res_shapes]
    launched = ctypes.c_int(0)
    d = table.desc.copy()
    d["res"] = res_ptrs
    d["res_out"] = [o.data_ptr() for o in out]
    d["grad"] = buf.data_ptr() + table.grad_bytes
    d["val"] = val.data_ptr() + table.stream_bytes
    d["lidx"] = lidx.data_ptr() + table.stream_bytes
    with torch.cuda.device(buf.device):
        rc = _build.lib().bucket_topk_ef_grouped_f32(
            d.ctypes.data, table.n, _build.stream(buf),
            ctypes.byref(launched))
    _build.check(rc, "bucket_topk")
    return out, launched.value
