"""Pedersen hash over the Jubjub curve (legacy hasher).

The reference declares a Pedersen hasher header but ships it empty
(reference: libs/storage/include/nil/filecoin/storage/proofs/core/
hasher/pedersen.hpp:27-34 — a bare namespace). rust-fil-proofs' legacy
test paths consume the sapling-crypto Pedersen hash; this module
implements that construction from the public Zcash protocol
specification (§5.4.1.7 PedersenHash, §5.4.9.5 GroupHash, §5.4.9.3
Jubjub) so the hasher row is a real implementation rather than a
waiver:

- Jubjub: the complete twisted Edwards curve a*x^2 + y^2 = 1 + d*x^2*y^2
  with a = -1, d = -(10240/10241), over Fq = BLS12-381's scalar field Fr
  (so Pedersen digests are native R1CS field elements, same as
  Poseidon's).
- Segment generators derived by the spec's BLAKE2s GroupHash with
  personalization "Zcash_PH" over the fixed URS, cofactor-cleared.
- Messages are split into 3-bit chunks, 63 chunks per segment; chunk
  (s0, s1, s2) encodes (1 + s0 + 2*s1) * (1 - 2*s2) weighted by
  2^(4*j), and each segment scalar multiplies its own generator.

This is a host-side legacy path (it exists for interop/test parity, not
the hot sealing pipeline — Poseidon/SHA own that), so the arithmetic is
plain Python ints like ops/poseidon.py's golden path.

Copied from crypto3_fil_proofs_tpu/ops/pedersen.py with its imports
rewritten.
"""
from __future__ import annotations

import hashlib
from functools import lru_cache

import numpy as np

from .bls12_381 import R as Q  # Jubjub base field == BLS12-381 Fr

# d = -(10240/10241) mod q  (Zcash spec §5.4.9.3)
D = (-10240 * pow(10241, -1, Q)) % Q

# Order of the prime-order subgroup (cofactor 8).
SUBGROUP_ORDER = (
    0x0E7DB4EA6533AFA906673B0101343B00A6682093CCC81082D0970E5ED6F72CB7
)
COFACTOR = 8

# Point representation: (x, y) affine ints; identity is (0, 1).
IDENTITY = (0, 1)

CHUNKS_PER_SEGMENT = 63  # spec's c


def is_on_curve(p) -> bool:
    x, y = p
    return (-x * x + y * y - 1 - D * x * x % Q * y % Q * y) % Q == 0


def add(p1, p2):
    """Complete twisted Edwards addition (a = -1): no exceptional cases,
    valid for doubling and identity alike (spec §5.4.9.3)."""
    x1, y1 = p1
    x2, y2 = p2
    x1x2 = x1 * x2 % Q
    y1y2 = y1 * y2 % Q
    dxy = D * x1x2 % Q * y1y2 % Q
    x3 = (x1 * y2 + y1 * x2) * pow(1 + dxy, -1, Q) % Q
    y3 = (y1y2 + x1x2) * pow(1 - dxy, -1, Q) % Q
    return (x3, y3)


def negate(p):
    x, y = p
    return ((-x) % Q, y)


def scalar_mul(k: int, p):
    acc = IDENTITY
    base = p
    k %= SUBGROUP_ORDER
    while k:
        if k & 1:
            acc = add(acc, base)
        base = add(base, base)
        k >>= 1
    return acc


def point_to_bytes(p) -> bytes:
    """repr_J: 32 bytes little-endian y with the x-parity in bit 255."""
    x, y = p
    b = bytearray(y.to_bytes(32, "little"))
    if x & 1:
        b[31] |= 0x80
    return bytes(b)


def _sqrt_fq(a: int):
    """Tonelli-Shanks in Fq (q - 1 = 2^32 * t); None if non-residue."""
    if a == 0:
        return 0
    if pow(a, (Q - 1) // 2, Q) != 1:
        return None
    # q - 1 = 2^s * t with t odd
    s, t = 32, (Q - 1) >> 32
    # 5 is a non-residue mod Q (generator of the 2-Sylow torsion)
    z = pow(5, t, Q)
    m, c = s, z
    r = pow(a, (t + 1) // 2, Q)
    u = pow(a, t, Q)
    while u != 1:
        # find least i with u^(2^i) == 1
        i, v = 0, u
        while v != 1:
            v = v * v % Q
            i += 1
        b = pow(c, 1 << (m - i - 1), Q)
        m, c = i, b * b % Q
        r = r * b % Q
        u = u * c % Q
    return r


def point_from_bytes(buf: bytes):
    """abst_J: inverse of point_to_bytes; None on invalid encoding."""
    if len(buf) != 32:
        return None
    b = bytearray(buf)
    sign = (b[31] >> 7) & 1
    b[31] &= 0x7F
    y = int.from_bytes(bytes(b), "little")
    if y >= Q:
        return None
    # a*x^2 + y^2 = 1 + d*x^2*y^2, a=-1  =>  x^2 = (y^2-1)/(d*y^2+1)
    y2 = y * y % Q
    denom = (D * y2 + 1) % Q
    if denom == 0:
        return None
    x2 = (y2 - 1) * pow(denom, -1, Q) % Q
    x = _sqrt_fq(x2)
    if x is None:
        return None
    if x == 0 and sign == 1:
        return None
    if (x & 1) != sign:
        x = Q - x
    return (x, y)


# --- GroupHash generator derivation (spec §5.4.9.5) -------------------

URS = b"096b36a5804bfacef1691e173c366a47ff5ba84a44f26ddd7e8d9f79d5b42df0"
PEDERSEN_PERSONALIZATION = b"Zcash_PH"


def group_hash(domain: bytes, msg: bytes):
    """GroupHash^(J(r)*): BLAKE2s-256(personal=domain, URS || msg)
    decoded as a point, cofactor-cleared; None if invalid/identity."""
    h = hashlib.blake2s(URS + msg, digest_size=32, person=domain).digest()
    p = point_from_bytes(h)
    if p is None:
        return None
    p8 = scalar_mul_cofactor(p)
    if p8 == IDENTITY:
        return None
    return p8


def scalar_mul_cofactor(p):
    p2 = add(p, p)
    p4 = add(p2, p2)
    return add(p4, p4)


def find_group_hash(domain: bytes, msg: bytes):
    for i in range(256):
        p = group_hash(domain, msg + bytes([i]))
        if p is not None:
            return p
    raise ValueError("find_group_hash failed after 256 attempts")


@lru_cache(maxsize=None)
def pedersen_generator(segment: int):
    """I_i = FindGroupHash("Zcash_PH", LE32(i)) (spec §5.4.8.2)."""
    return find_group_hash(
        PEDERSEN_PERSONALIZATION, segment.to_bytes(4, "little")
    )


# --- PedersenHash (spec §5.4.1.7) --------------------------------------


def bytes_to_bits(data: bytes) -> list[int]:
    """Little-endian bit order within each byte (sapling convention)."""
    out = []
    for byte in data:
        for i in range(8):
            out.append((byte >> i) & 1)
    return out


def pedersen_hash_bits(bits: list[int], personalization: list[int] = ()):
    """Hash a bit string to a Jubjub point."""
    m = list(personalization) + list(bits)
    if not m:
        m = [0]
    while len(m) % 3:
        m.append(0)
    acc = IDENTITY
    seg_bits = 3 * CHUNKS_PER_SEGMENT
    for seg_idx in range(0, len(m), seg_bits):
        seg = m[seg_idx : seg_idx + seg_bits]
        scalar = 0
        for j in range(0, len(seg), 3):
            s0, s1, s2 = seg[j], seg[j + 1], seg[j + 2]
            enc = (1 + s0 + 2 * s1) * (1 - 2 * s2)
            scalar += enc * (1 << (4 * (j // 3)))
        gen = pedersen_generator(seg_idx // seg_bits)
        acc = add(acc, scalar_mul(scalar % SUBGROUP_ORDER, gen))
    return acc


def pedersen_hash(data: bytes, personalization: list[int] = ()) -> int:
    """Digest = Extract_J (the x-coordinate), a native Fr element."""
    return pedersen_hash_bits(bytes_to_bits(data), personalization)[0]


def pedersen_md_no_padding(data: bytes) -> int:
    """Merkle-Damgard chaining for inputs > 2 blocks: hash the first two
    32-byte blocks, then fold each following block with the running
    digest (rust-fil-proofs' pedersen_md_no_padding shape, consumed by
    the legacy hasher's hash_multi paths)."""
    assert len(data) >= 64 and len(data) % 32 == 0
    digest = pedersen_hash(data[:64])
    for off in range(64, len(data), 32):
        block = digest.to_bytes(32, "little") + data[off : off + 32]
        digest = pedersen_hash(block)
    return digest


class PedersenBackend:
    """Tree-hash backend (ops/tree_hash.py contract): level arrays of
    (N, 32)-byte nodes in, (N/arity, 32) out. Legacy/test path — host
    ints, like the Poseidon golden backend. `leaf_bytes` and
    `tree_levels` are the port's Merkle engine's interface
    (core/merkle/tree.py `MerkleTree.build`), over `hash_level`."""

    name = "pedersen"

    def leaf_bytes(self, leaves) -> np.ndarray:
        return np.asarray(leaves, dtype=np.uint8)

    def tree_levels(self, leaves, arity: int, device=None):
        """Each level above the leaves as (n, 32) bytes, on the host
        whatever `device` says: there is no device Pedersen."""
        level = self.leaf_bytes(leaves)
        while level.shape[0] > 1:
            level = self.hash_level(level, arity)
            yield level

    def hash_single(self, children: list[bytes]) -> bytes:
        data = b"".join(children)
        # Node payloads are whole 32-byte field elements; reject
        # malformed buffers up front (pedersen_md_no_padding would
        # assert on them anyway — ADVICE r3).
        if len(data) < 32 or len(data) % 32:
            raise ValueError(f"pedersen node payload must be k*32 bytes, got {len(data)}")
        if len(data) <= 64:
            digest = pedersen_hash(data)
        else:
            digest = pedersen_md_no_padding(data)
        return digest.to_bytes(32, "little")

    def hash_level(self, nodes: np.ndarray, arity: int) -> np.ndarray:
        assert nodes.shape[0] % arity == 0
        raw = np.ascontiguousarray(nodes, dtype=np.uint8).tobytes()
        out = np.empty((nodes.shape[0] // arity, 32), dtype=np.uint8)
        step = 32 * arity
        for i in range(out.shape[0]):
            digest = self.hash_single([raw[i * step : (i + 1) * step]])
            out[i] = np.frombuffer(digest, dtype=np.uint8)
        return out
