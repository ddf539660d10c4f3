"""Per-face record fetch: each pixel's winning face id -> that face's
packed record.

The plain version of the port's kernel ``csrc/table.cu``, which replaces
the JAX package's
``ops/pallas/table.py::_lookup_kernel`` (``vmem_table_lookup``): the
function is ``tab[clip(iy), clip(ix)]`` with ``iy = max(id, 0) // 128``
and ``ix = max(id, 0) % 128`` over the (rows, 128, K) record table
(``scene/rasterizer._pack_face_table``), for all K channels at once
(the TPU split the record into chunks of 8). The TPU's ``MAX_ROWS`` gate
priced its select chain and is not semantics: one kernel serves every
table size. Kernel and plain version are both a copy, bit-identical.
"""

from __future__ import annotations

import torch


LANES = 128


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
    ids ``ids`` (H, W) int32 (a negative id reads face 0)."""
    return face_lookup_plain(table, ids)


