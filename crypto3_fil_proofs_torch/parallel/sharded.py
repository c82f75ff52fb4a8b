"""A mesh of devices and the sharded Merkle tree, NTT and MSM over it.

Counterpart of crypto3_fil_proofs_tpu/parallel/sharded.py (`make_mesh`
:33, `msm_sharded_buckets` :42, `msm_sharded` :107, `ntt_sharded` :196,
`build_tree_sharded` :268). The JAX functions are single-controller: one
process drives a `Mesh` of devices through `shard_map` and gets the
results back whole. So does this module:

- A `Mesh` is an ordered tuple of torch devices, one per shard; a card
  may repeat. On CUDA shard i runs on cuda:(i mod the card count), so 8
  shards on one H100 share it, and with more cards they spread over
  them; on the CPU every shard is `cpu`. `make_mesh` never hands back
  CPU devices for a CUDA request: without a card it raises.
- `Mesh.map` runs each CUDA shard's work in a thread of its own, under
  the shard's device and a stream of its own (the kernel wrappers launch
  on the thread's current stream, and their ctypes calls release the
  GIL), and waits for every shard's stream before it returns. CPU shards
  run one after another.
- The collectives are plain functions over the shards' tensors, called
  between two `map`s: `all_gather` copies every shard's tensor to one
  device and stacks them in shard order; `all_to_all` moves block
  (d, e) from shard d to shard e. A mesh over a process group would
  replace these two and `map`, and nothing else.

No function here has a kernel of its own: the tree runs on K2, the NTT
on K3 (its batched pass) and K1, the MSM on K6 with K4 / K5. On CPU
tensors the wrappers run their plain versions, so the same code is the
plain sharded path. Results do not depend on the number of shards: the
field values are canonical and a group element is unique.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from functools import lru_cache

import torch

from ..api.seal import check_device
from ..ops import field as F
from ..ops import msm as M
from ..ops import ntt as N
from ..ops.bls12_381 import R
from ..ops.cuda import field as k1
from ..ops.cuda import ntt as k3
from ..ops.g1_torch import G1
from ..ops.g2_torch import G2
from ..ops.poseidon_torch import hash_level


class Mesh:
    """One torch device per shard, in shard order, each shard with a
    stream of its own (CUDA)."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        # CPU shards run one after another: the plain versions are many
        # small torch ops, and threads would only take turns at the GIL
        self.threads = any(d.type == "cuda" for d in self.devices)
        self._streams: dict[int, torch.cuda.Stream] = {}

    @property
    def shards(self) -> int:
        return len(self.devices)

    def distinct(self) -> list[torch.device]:
        """The mesh's devices, each once, in the order of first use."""
        return list(dict.fromkeys(self.devices))

    @property
    def cards(self) -> int:
        """How many distinct CUDA devices the shards run on."""
        return sum(d.type == "cuda" for d in self.distinct())

    def __repr__(self) -> str:
        return f"Mesh({self.shards} shards on {', '.join(map(str, self.distinct()))})"

    def map(self, fn, *per_shard) -> list:
        """[fn(i, a[i], b[i], ...) for each shard i], each call in its
        own thread (on CUDA) under the shard's device and stream. The streams first
        wait on the calling thread's streams (the inputs were made
        there), and each is synchronized before `map` returns, so the
        results are ready for the collectives and the caller."""
        callers = caller_streams(self.distinct())
        for i, d in enumerate(self.devices):
            if d.type == "cuda" and i not in self._streams:
                self._streams[i] = torch.cuda.Stream(device=d)

        def run(i):
            d = self.devices[i]
            with on_device(d, self._streams.get(i), callers.get(d)):
                return fn(i, *[a[i] for a in per_shard])

        if self.shards == 1 or not self.threads:
            return [run(i) for i in range(self.shards)]
        with ThreadPoolExecutor(max_workers=self.shards) as pool:
            return list(pool.map(run, range(self.shards)))


def caller_streams(devices) -> dict:
    """The calling thread's current stream of each CUDA device."""
    return {d: torch.cuda.current_stream(d) for d in devices if torch.device(d).type == "cuda"}


@contextmanager
def on_device(device, stream=None, after=None):
    """Run the block under a CUDA `device` and `stream` (a new one by
    default), which first waits on `after` (default: the device's current
    stream on entry); the stream is synchronized on exit, so what the
    block made is ready for any thread. A CPU device runs it as it is."""
    dev = torch.device(device)
    if dev.type != "cuda":
        yield
        return
    after = after if after is not None else torch.cuda.current_stream(dev)
    stream = stream if stream is not None else torch.cuda.Stream(device=dev)
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        stream.wait_stream(after)
        yield
    stream.synchronize()


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A mesh of `n_devices` shards (default: one per card, or one CPU
    shard). On CUDA shard i runs on cuda:(i mod torch.cuda.device_count()),
    and a machine without CUDA raises; on the CPU every shard is `cpu`."""
    dev = check_device(device)
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n_devices}")
    if dev.type == "cpu":
        return Mesh(["cpu"] * (n_devices or 1))
    count = torch.cuda.device_count()
    return Mesh([torch.device("cuda", i % count) for i in range(n_devices or count)])


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def all_gather(tensors: list[torch.Tensor], device) -> torch.Tensor:
    """Every shard's tensor copied to `device` and stacked in shard order."""
    return torch.stack([t.to(device) for t in tensors])


def all_to_all(blocks: list[list[torch.Tensor]], mesh: Mesh) -> list[list[torch.Tensor]]:
    """blocks[d][e] lies on shard d; shard e receives [blocks[d][e] for
    each d], on its device."""
    return [[blocks[d][e].to(mesh.devices[e]) for d in range(mesh.shards)] for e in range(mesh.shards)]


def _scatter(parts: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    return [p.contiguous().to(d) for p, d in zip(parts, mesh.devices)]


# ---------------------------------------------------------------------------
# The Merkle tree: one sub-tree per shard
# ---------------------------------------------------------------------------


def build_tree_sharded(leaves: torch.Tensor, arity: int, mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """(sub_roots [D, 8], top [8]) of int32 [N, 8] Montgomery leaves:
    shard d hashes leaves [d N / D, (d + 1) N / D) to one root on K2, and
    the gathered roots fold with arity-2 Poseidon (the compound sub/top
    combine of JAX :268-300). Both lie on the leaves' device."""
    n, d = leaves.shape[0], mesh.shards
    per = n // d
    if n % d or not _is_power(per, arity):
        raise ValueError(f"{n} leaves over {d} shards: each shard's {n / d} leaves are not a power of {arity}")
    if d & (d - 1):
        raise ValueError(f"the top fold is binary: {d} shards is not a power of two")

    def subtree(i, block):
        level = block
        while level.shape[0] > 1:
            level = hash_level(level, arity)
        return level[0]

    roots = all_gather(mesh.map(subtree, _scatter(list(leaves.split(per)), mesh)), leaves.device)
    top = roots
    while top.shape[0] > 1:
        top = hash_level(top, 2)
    return roots, top[0]


def _is_power(n: int, base: int) -> bool:
    """n == base^k for some k >= 0."""
    while n > 1 and base > 1 and n % base == 0:
        n //= base
    return n == 1


# ---------------------------------------------------------------------------
# The NTT: four steps, the transpose between them one all_to_all
# ---------------------------------------------------------------------------


def split(log_n: int) -> tuple[int, int]:
    """(logR, logC) of the four-step split, as the JAX package's `_plan`
    (ops/pallas/ntt.py:479-483): logR = ceil(log_n / 2)."""
    log_r = (log_n + 1) // 2
    return log_r, log_n - log_r


@lru_cache(maxsize=4)
def inter_step(log_n: int, inverse: bool, device: str) -> torch.Tensor:
    """The inter-step twiddles, int32 [C, R, 8] Montgomery on `device`:
    w^(j k) at [j, k] (w^(-j k) / n for the inverse, whose 1/n rides
    here, as the JAX package's `t1i`). Built by doubling over the rows:
    rows [m, 2m) are rows [0, m) times (w^m)^k, one K1 product over the
    block plus the log2(R) products of that row's powers."""
    log_r, log_c = split(log_n)
    rows, cols = 1 << log_c, 1 << log_r
    d = N.domain(log_n)
    base, scale = (d.omega_inv, d.n_inv) if inverse else (d.omega, 1)
    out = torch.empty((rows, cols, F.FR.n32), dtype=torch.int32, device=device)
    out[0] = F.ints_to_limbs32([scale * F.FR.mont_r % R])[0].to(device)
    m = 1
    while m < rows:
        step = N.mont_powers(pow(base, m, R), cols, device=device)
        out[m : 2 * m] = k1.montmul(out[:m].reshape(-1, F.FR.n32), step.repeat(m, 1)).reshape(m, cols, F.FR.n32)
        m *= 2
    return out


def ntt_sharded(a: torch.Tensor, log_n: int, mesh: Mesh, inverse: bool = False) -> torch.Tensor:
    """The NTT of int32 [n, 8] Montgomery values, natural order in and out,
    equal to the single-device `ntt` / `intt` of ops/cuda/ntt.py (the
    inverse includes 1/n). As a matrix X[j1, j2] = a[C j1 + j2] of R rows
    and C columns, shard d holds C / D columns: it transforms them (one
    batched call over its columns: one K3b launch for rows of at most
    2^12) and multiplies by its rows of `inter_step` (K1). The
    all_to_all hands shard e the R / D rows of its block; it transforms
    them (batched again) into Y[k1, k2] = out[k1 + R k2].
    The result lies on a's device."""
    n = 1 << log_n
    if a.dtype != torch.int32 or a.shape != (n, F.FR.n32):
        raise ValueError(f"expected int32 [{n}, {F.FR.n32}], got {a.dtype} {tuple(a.shape)}")
    log_r, log_c = split(log_n)
    rows, cols, d = 1 << log_r, 1 << log_c, mesh.shards
    if rows % d or cols % d:
        raise ValueError(f"{d} shards do not divide both factors of 2^{log_n} ({rows} x {cols})")
    cb, rb = cols // d, rows // d
    kind = "tw_inv" if inverse else "tw_fwd"
    for dev in mesh.distinct():  # the cached tables, before the threads
        for lg in (log_r, log_c):
            if lg:
                N.table(lg, kind, str(dev))
                N.table(lg, "bitrev", str(dev))
        inter_step(log_n, inverse, str(dev))
    x = a.reshape(rows, cols, F.FR.n32)
    # shard i's columns, each as a row of R elements: [C / D, R, 8]
    columns = _scatter([x[:, i * cb : (i + 1) * cb].transpose(0, 1) for i in range(d)], mesh)

    def first(i, col):
        z = k3.transform(col, log_r, inverse)
        tw = inter_step(log_n, inverse, str(col.device))[i * cb : (i + 1) * cb]
        z = k1.montmul(z.reshape(-1, F.FR.n32), tw.reshape(-1, F.FR.n32)).reshape(cb, rows, F.FR.n32)
        return [z[:, e * rb : (e + 1) * rb] for e in range(d)]  # block (i, e): [C / D, R / D, 8]

    received = all_to_all(mesh.map(first, columns), mesh)

    def second(i, parts):
        y = torch.cat(parts).transpose(0, 1).contiguous()  # [R / D, C, 8]: row k1, column j2
        return k3.transform(y, log_c, inverse)

    y = torch.cat([t.to(a.device) for t in mesh.map(second, received)])  # [R, C, 8]: Y[k1, k2]
    return y.transpose(0, 1).contiguous().reshape(n, F.FR.n32)


# ---------------------------------------------------------------------------
# The MSM: buckets per shard, merged per window block, aggregated per shard
# ---------------------------------------------------------------------------


def _curve(name: str):
    if name not in ("g1", "g2"):
        raise ValueError(f"curve must be 'g1' or 'g2', not {name!r}")
    return G1 if name == "g1" else G2


def _window_bits(n_buckets: int) -> int:
    c = n_buckets.bit_length() - 1
    if n_buckets != 1 << c or not 1 <= c <= 16:
        raise ValueError(f"n_buckets must be a power of two from 2 to 2^16, not {n_buckets}")
    return c


def _merged_windows(curve, points, scalars, mesh: Mesh, c: int):
    """Shard e's block of windows [e Wl, (e + 1) Wl) with every shard's
    buckets of them added up: ([Wl * 2^c, 3, ...] per shard, W, Wl).

    Each shard schedules its points (one window width c and one window
    count W for all, from the whole input) and sums them into buckets on
    K6. The merge is JAX's all_gather and add fold restricted to each
    shard's windows: an all_to_all of window blocks, then D - 1 K4/K5
    adds on each shard, so no device holds D bucket sets."""
    if points.shape[0] != scalars.shape[0]:
        raise ValueError("one scalar per point")
    if points.shape[0] < mesh.shards:
        raise ValueError(f"{points.shape[0]} points for {mesh.shards} shards")
    pk, bk = M.kernels(curve)
    nb, d = 1 << c, mesh.shards
    windows = max(1, -(-M.scalar_bits(scalars) // c))
    wl = -(-windows // d)

    def accumulate(i, pts, sc):
        sched = M.schedule(sc, c, windows)
        chunks = bk.bucket_acc(pts, sched.order, sched.start, sched.length)
        buckets = M.reduce_buckets(bk, chunks, sched.chunk_ptr)
        pad = curve.infinity(wl * d * nb - buckets.shape[0], buckets.device)
        buckets = torch.cat([buckets, pad])
        return [buckets[e * wl * nb : (e + 1) * wl * nb] for e in range(d)]

    blocks = mesh.map(accumulate, _scatter(list(points.tensor_split(d)), mesh),
                      _scatter(list(scalars.tensor_split(d)), mesh))

    def merge(i, parts):
        acc = parts[0].contiguous()
        for q in parts[1:]:
            acc = pk.add(acc, q.contiguous())
        return acc

    return mesh.map(merge, all_to_all(blocks, mesh)), windows, wl


def msm_sharded_buckets(points: torch.Tensor, scalars: torch.Tensor, mesh: Mesh, n_buckets: int = 1 << 16,
                        curve: str = "g1") -> torch.Tensor:
    """The sharded half of the MSM (JAX :42-104): the bucket sums of
    affine points [N, 2, ...] and int32 [N, 8] canonical scalars, merged
    over the shards, as Jacobian [W, n_buckets, 3, ...] on the points'
    device (window w, bucket b = the sum of the points whose w-th
    c-bit digit is b; bucket 0 is infinity)."""
    cv = _curve(curve)
    c = _window_bits(n_buckets)
    merged, windows, _ = _merged_windows(cv, points, scalars, mesh, c)
    flat = torch.cat([t.to(points.device) for t in merged])[: windows << c]
    return flat.reshape((windows, 1 << c, 3) + cv.coord)


def msm_sharded(points: torch.Tensor, scalars: torch.Tensor, mesh: Mesh, n_buckets: int = 1 << 16,
                curve: str = "g1"):
    """sum_i s_i P_i over the mesh (JAX :107-193), as a host Jacobian point
    equal to ops/msm.py `msm`'s. After the bucket merge each shard
    aggregates its Wl windows (K6 `agg_level`, ops/msm.py `aggregate`);
    the all_gather brings the W window totals T_w to the points' device,
    where masked K4/K5 doublings scale T_w by 2^(c w) (step k doubles the
    windows with k < c w) and a halving fold of adds sums them. JAX scales
    each shard's windows on the shard; the loop's depth is c (W - 1) on
    the shard of the top windows whatever the split, so that saves no
    time, and done once it costs c (W - 1) doublings in all, not about
    c W D / 2. No host algebra comes before the final point."""
    cv = _curve(curve)
    c = _window_bits(n_buckets)
    pk, _ = M.kernels(cv)
    merged, windows, wl = _merged_windows(cv, points, scalars, mesh, c)
    totals = mesh.map(lambda i, buckets: M.aggregate(cv, buckets, wl, 1 << c), merged)
    acc = torch.cat([t.to(points.device) for t in totals])[:windows]
    shift = c * torch.arange(windows, device=acc.device)
    for k in range(c * (windows - 1)):
        acc = pk.dbl(acc, k < shift)
    return cv.host_point(M.fold(cv, acc))
