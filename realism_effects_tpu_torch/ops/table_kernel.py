"""Per-face record fetch: each pixel's winning face id -> that face's
packed record.

Kernel: ``csrc/table.cu``. It replaces the JAX package's
``ops/pallas/table.py::_lookup_kernel`` (``vmem_table_lookup``): the
function is ``tab[clip(iy), clip(ix)]`` with ``iy = max(id, 0) // 128``
and ``ix = max(id, 0) % 128`` over the (rows, 128, K) record table
(``scene/rasterizer._pack_face_table``), for all K channels at once
(the TPU split the record into chunks of 8). The TPU's ``MAX_ROWS`` gate
priced its select chain and is not semantics: one kernel serves every
table size. Kernel and plain version are both a copy, bit-identical.

On the H100 the fetch is bound by bytes, 4 B of id in and 4 K B out a
pixel. A block of the kernel owns 256 whole pixels: it loads their ids
once and stages the records' addresses in shared memory, then writes
its 256 x K output floats in order with 16-byte stores (16-byte loads
too where K % 4 == 0 and the table is 16-byte aligned), its index
arithmetic 32-bit and free of division. The first version, a thread per
output float dividing a 64-bit index by the run-time K, was bound by
that division's instructions.
"""

from __future__ import annotations

import torch

from . import cuda_build

LANES = 128
_INT32_MAX = (1 << 31) - 1
_PIX_BLOCK = 256  # pixels a block of the kernel (csrc/table.cu kPix)


def _indices(table, ids):
    safe = torch.clamp(ids, min=0)
    r = torch.clamp(safe // LANES, 0, table.shape[0] - 1).long()
    return r, (safe % LANES).long()


def face_lookup_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch: advanced indexing."""
    r, l = _indices(table, ids)
    return table[r, l]


def face_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(H, W, K) records of ``table`` (rows, 128, K) float32 at the face
    ids ``ids`` (H, W) int32 (a negative id reads face 0). CUDA tensors
    launch the kernel; CPU tensors take the plain version."""
    if table.device.type == "cpu":
        return face_lookup_plain(table, ids)
    return _launch(table, ids)


def _launch(table, ids):
    if table.ndim != 3 or table.shape[1] != LANES or table.dtype != torch.float32:
        raise ValueError(f"the record table must be (rows, {LANES}, K) "
                         f"float32, not {tuple(table.shape)} {table.dtype}")
    if ids.dtype != torch.int32:
        raise ValueError(f"face ids must be int32, not {ids.dtype}")
    rows, _, k = table.shape
    # the kernel's indices are 32-bit: record rows * 128, pixels, and the
    # floats a block writes each stay below 2^31
    if rows > _INT32_MAX // LANES or ids.numel() > _INT32_MAX or \
            k > _INT32_MAX // (4 * _PIX_BLOCK):
        raise ValueError(f"record table {tuple(table.shape)} with {ids.numel()} "
                         "face ids is beyond the kernel's 32-bit indices")
    table, ids = table.contiguous(), ids.contiguous()
    cuda_build.require_cuda(table, ids)
    out = torch.empty(tuple(ids.shape) + (k,), dtype=torch.float32,
                      device=table.device)
    cuda_build.launch("lookup", "table", "re_lookup", (3, 3), table,
                      table.data_ptr(), ids.data_ptr(), out.data_ptr(), rows, k,
                      ids.numel())
    return out
