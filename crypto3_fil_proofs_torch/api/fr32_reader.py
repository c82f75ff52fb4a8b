"""Streaming fr32 padder (reference libs/filecoin fr32_reader.hpp:37-273).

Copied from crypto3_fil_proofs_tpu/api/fr32_reader.py.

`Fr32Reader` wraps a byte source and emits the bit-padded stream
incrementally — the shape `add_piece`/`generate_piece_commitment`
consume. The heavy lifting stays in the vectorized core/fr32 padder;
the reader only manages 127-byte-aligned buffering (127 unpadded bytes
= 1016 bits = four whole 254-bit lanes pad to exactly 128 bytes, so
chunk boundaries are stream-exact); the reference's per-bit
Buffer::read_bit/read_u8..u64 machinery collapses into these aligned
batch reads.
"""
from __future__ import annotations

import io

from ..core.fr32 import write_padded

UNPADDED_CHUNK = 127  # pads to exactly 128 bytes
_READ_SIZE = UNPADDED_CHUNK * 512


class Fr32Reader:
    """Read-side adapter: .read(n) yields fr32-padded bytes."""

    def __init__(self, source):
        if isinstance(source, (bytes, bytearray)):
            source = io.BytesIO(bytes(source))
        self._source = source
        self._buf = b""      # already-padded output
        self._pending = b""  # unpadded bytes below a 127-byte boundary
        self._eof = False

    def _fill(self, need: int) -> None:
        while len(self._buf) < need and not self._eof:
            raw = self._source.read(_READ_SIZE)
            if not raw:
                self._eof = True
                break
            self._pending += raw
            usable = len(self._pending) // UNPADDED_CHUNK * UNPADDED_CHUNK
            if usable:
                self._buf += write_padded(self._pending[:usable])
                self._pending = self._pending[usable:]
        if self._eof and self._pending:
            # final partial group: tail element zero-filled by the padder
            self._buf += write_padded(self._pending)
            self._pending = b""

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            self._fill(1 << 62)
            out, self._buf = self._buf, b""
            return out
        self._fill(n)
        out, self._buf = self._buf[:n], self._buf[n:]
        return out
