#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (crypto3_fil_proofs_torch) on one GPU.

Builds the hand-written CUDA kernels from csrc/, holds each against its
plain PyTorch version on the card, then drives the port's paths
through its entry points:
- SDR pre-commit (PC1 on the host, PC2's Poseidon work on the GPU): a
  2 KiB sector against the JAX package's frozen commitments
  (tests/golden/torch_precommit_2k.json) and one full 512 MiB sector,
  whose stored tree nodes and column hashes are spot-checked against the
  host Poseidon;
- Groth16 prove (h(x) NTTs, G1 and G2 MSMs on the GPU): the cubic circuit
  against the JAX package's frozen proof bytes
  (tests/golden/torch_groth16_cubic.npz), and one prove at the size of
  Winning PoSt over a 32 GiB sector (2^19 domain) under a synthetic key of
  known discrete logs, whose proof is recomputed on the host in the
  exponent;
- seal commit of the 512 MiB sector: C1 (host), Groth16 setup of the
  stacked circuit through `paramcache` (fixed-base batches and their
  normalisation on the GPU), the phase-2 ceremony on that key (its
  query rescaling on the GPU), C2 under the contributed key (the prove
  on the GPU) and verify_seal (host pairing);
- unseal of that sector (host: the labeler regenerates the key layer, a
  numpy decode and unpad) and its fallback PoSt, Winning and Window: the
  vanilla proofs from the stored tree_r_last (host), the circuit (host),
  the Groth16 key made by setup through the parameter cache and the
  proof on the GPU, verification on the host; its LevelCache tree's
  proofs (the discarded rows rebuilt on the GPU); and the 2 KiB sector's
  PoSt against the JAX package's frozen keys and proofs
  (tests/golden/torch_post.json);
- the parameter lifecycle at 2 KiB: paramcache, a contribution and a
  PoSt under it, and the parameter files published and fetched through
  stand-ins for `ipfs` and `ipget` (no network);
- the legacy protocols: DRG PoRep of the drg8 instance (replication on
  the host, its 2^21-domain Groth16 setup and prove on the GPU) against
  tests/golden/drg8, Election PoSt of the 512 MiB sector (setup and
  prove on the GPU) and of the 2 KiB sector against the JAX package's
  frozen key and proof (tests/golden/torch_election_2k.json), and
  Rational PoSt (host);
- the multi-device layer (crypto3_fil_proofs_torch/parallel/): a mesh of
  8 shards on the card(s), the sharded Merkle tree, NTT and MSMs at the
  shapes of the frozen JAX golden (tests/golden/torch_sharded.json) and
  at full width (the 512 MiB replica's tree_r_last, the 2^23 NTT, the
  512 MiB key's h_query and b_g2_query), K3b (the four-step NTT's
  batched rows, each whole in one block's shared memory),
  partition-parallel prove_many (a two-partition Window PoSt), and the
  seal_many pipeline of two 512 MiB sectors;
- the circuits' Poseidon witness replay (kernel K7), which every
  witness-bearing circuit above runs on the card (phases 13, 15, 17, 18,
  19, 21, 30), alone at the full width of a 32 GiB Window PoSt partition
  and of a 32 GiB C2 partition's columns (phase 32).

Phases:
  1. print the card's name and power limit; build the kernels; measure
     the rate of 32-bit integer multiply-adds (csrc/imad_probe.cu)
  2. K1 (Fr and Fq Montgomery product) against the plain version: Fr at
     the path's 2^24 elements times R^2, Fr and Fq on 2^20 random pairs
     (0, 1 and p - 1 included)
  3. K2 (Poseidon) against the plain version at the path's shapes
     (arity 2: one column batch; arity 8: 2^21 states, every 127th row
     compared) and for arity 11 at one column batch of a 32 GiB tree_c
     (400,000 states, every 61st row compared); 16 digests each against
     the host poseidon_hash
  4. the 2 KiB pre-commit on cuda against the frozen JAX commitments
  5. the 512 MiB pre-commit on cuda (launch counts, per-phase times,
     peak device memory, sampled node checks, comm_r = H(comm_c, comm_r_last)),
     then, after those checks, its PC2 once more under torch.profiler
  6. K1 and K2 rows of the `kernels` line: time at the path's shape,
     launches on the 512 MiB run, the plain version's time, the bound
  7. K3 (NTT) at 2^17, 2^18, 2^19 and 2^21 and on single vectors of
     2^1 .. 2^13, forward and inverse, against the plain transform; the
     coset transforms at 2^19; the batched h_from_evals against the plain
     h chain at 2^17 and 2^19; K3m (K1 products and fr_sub) at 2^19, the
     two 20 us kernels' device time by the profiler; K3's time and bound
     at each domain (2^23 timed in phase 27)
  8. K4 and K5 (madd_nodbl, dbl, add; G1's madd, off every path; K5 on
     two threads per point) against the plain versions on a block of
     every edge case, at the start and end of blocks, on 2^19 lanes
     (2^16 of them compared) and at every lane count of the prove's
     scalar-1 sums (every lane compared)
  9. K6: G1 and G2 MSMs at the path's sizes over tiled bases of known
     logs against (sum s_i k_i) G on the host; the plain MSM on 4096 points
 10. the cubic circuit proved on cuda == the frozen JAX bytes; verify
 11. prove_from_assignment with h_from_evals at the sizes of the port's
     blank Winning PoSt circuit over a 32 GiB sector (282,191
     constraints, 286,814 variables, 68 inputs, 2^19 domain; the script
     synthesizes the blank circuit and fails where its counts differ),
     under a synthetic key and witness: h passes A(t)B(t) - C(t) =
     h(t)(t^n - 1) at a random t, its coefficient n - 1 is 0, and the
     proof bytes equal A, B, C computed on the host in the exponent;
     stage times, launches and peak memory; then the same prove under
     torch.profiler (device time by kernel and the device's busy share)
 12. the `kernels` JSON line (assembled last): K1-K6 at the paths'
     shapes (K3b, the batched rows, apart: phase 29), launches on each path, device ms
     on each path (traced PC2, prove, commit path, phase-2 contribution,
     the two PoSt paths, DRG `dg`, Election `el`, the multi-device
     paths `sh`, `pm` and `sm`, and the witness replay `wr`; K7 among them;
     the LevelCache proofs' launches), bounds (K4 dbl and g1_madd also
     for the phase-2 path), plain times, registers and spills
 13. C1 of the 2 KiB sector of phase 4 against the frozen JAX digest
     (tests/golden/torch_commit_2k.json), its registered stacked circuit
     (two challenges: segments, assignment, inputs; its Poseidon witness
     replayed on K7, which must launch) against the frozen
     JAX digests (tests/golden/torch_commit_2k_circuit.json), and C1 of
     the 512 MiB sector of phase 5, whose vanilla proofs must verify
 14. the commit path of the 512 MiB sector, traced, counts from 0 just
     before each of its two runs: `paramcache`'s cache_porep_params, the
     setup of the blank stacked circuit (6,893,314 constraints, 2^23) on
     cuda into the run's parameter cache; then the fixed-base batches
     against the plain versions on the card and against the key's rows,
     on 4,096 G1 and 1,024 G2 scalars whose u, v, w are recomputed from
     the rows (0, 1, r - 1 included), and the K1 normalisation against
     the plain one
 20. (between 14 and 15) the phase-2 ceremony on that key, its own path
     with the counts from 0 just before it: `phase2 contribute --seed`
     rescales l_query and h_query by d^-1 on cuda (K4 dbl and g1_madd,
     K1 fq); 1,026 lanes of each == the plain version on the card == host
     g1_mul; `verify old new` passes, a copy with delta_g2 unscaled
     fails; `small --out`, `merge --original`, `split-keys --prefix` put
     the contributed key in the cache; df before and after
 15. seal_commit_phase2 of that sector on cuda under the contributed key
     (its load, synthesis with the witness replay on K7, which must
     launch, h, the five MSMs, assembly); its 192-byte
     proof passes verify_seal with the contributed vk, and the original
     vk, a flipped bit and a wrong seed do not; stage times, launches,
     peak memory
 16. unseal of the 512 MiB replica of phase 5, in a thread beside
     phases 6-14 (host work): get_unsealed_range of the whole sector ==
     the staged piece, made again from its seed (wall time split into
     key regeneration, decode and unpad); then unseal_range at an odd
     offset and length == the piece's slice
 17. (phases 17-19 and 21-25 run in a second process of the script,
     beside phases 14, 28, 20 and 15; the launch counts and traces of
     each path are that process's own) Winning PoSt of that sector (66
     challenges, 225,827 constraints) on cuda, traced, counts from 0
     just before it: the parameter cache's setup (a private cache) and
     generate_winning_post; the
     192-byte proof verifies, a flipped bit and a wrong randomness do
     not; stage times (vanilla, synthesis, the satisfaction check,
     setup's and prove's spans, the Poseidon witness replay
     `poseidon_witness_v` on K7, which must launch),
     launches, device busy share, peak memory; then
     generate_winning_post_sector_challenge == the frozen JAX values;
     then a compacted copy of tree_r_last reopened over the replica as a
     LevelCache tree on cuda: its 66 proofs == the full store's, each
     rebuilding its segment on K2 (launches counted from 0)
 18. Window PoSt of that sector (10 challenges x 2 sectors, the sector
     duplicated: one partition of 68,838 constraints), as phase 17
 19. the 2 KiB sector of phase 4 proved on cuda with Winning (2 x 1) and
     Window (10 x 2) PoSt, each key made by setup in a private
     parameter cache: key digests and proof bytes == the frozen JAX
     golden (tests/golden/torch_post.json); both verify
 21. `paramcache --only-post` for 2 KiB on cuda into a fresh cache: the
     Window key (10 x 2) == the golden's digest and counts; the Winning
     key (66 x 1) contributed to on cuda, verified and split into a
     second cache, whose Winning PoSt of phase 4's sector verifies with
     the contributed vk and not with the original
 22. the parameter files: param.py digests, `parampublish` with
     fakeipfsadd as `ipfs`, `paramfetch` into an empty cache (equal
     digests; a corrupted file refetched, a wrong digest refused)
 23. DRG PoRep of drg8 (8 nodes, degree 6, one challenge; 1,989,928
     constraints, 2^21 domain), remade as scripts/drg_groth16_e2e.py
     makes it: replication on the host == the golden commitments,
     extract_all, the vanilla proof; then, traced with the counts from 0
     (path `dg`), setup in a private cache and prove on cuda: the vk ==
     tests/golden/drg8/vk.npz array for array, the proof == proof.bin;
     it verifies, a flipped bit and a wrong replica id do not; stage
     times, launches, device busy share, peak memory
 24. Election PoSt (40 challenges x 1 node, 139,099 constraints) of the
     512 MiB sector of phase 5 over its stored tree_r_last: candidates on
     the host (hash_md), then setup and prove on cuda as phase 23 (path
     `el`); it verifies, a flipped bit and a wrong partial ticket do
     not; then Rational PoSt (host) over the same tree with a second
     sector faulty
 25. the 2 KiB Election PoSt (2 x 1) of phase 4's sector on cuda: the
     candidate, key digest, verifying key and proof bytes == the frozen JAX
     golden (tests/golden/torch_election_2k.json); it verifies
 26. (after phase 9) the mesh: make_mesh(8), its shards, its distinct
     cards and torch.cuda.device_count(); build_tree_sharded (512 leaves,
     arity 8), ntt_sharded (2^12, forward and inverse) and G1
     msm_sharded (32 points, 16 buckets) on it == the frozen JAX golden
     (tests/golden/torch_sharded.json)
 27. path `sh`, counts from 0 just before each run: build_tree_sharded
     over phase 5's 512 MiB replica (2^24 leaves, arity 8) on 8 shards,
     its sub-roots == tree_r_last's stored level of 8 nodes and its top
     == the host Poseidon-2 fold; the single-device K3 ntt / intt at
     2^23, forward and inverse, == ntt_sharded (K3b); each traced beside the
     single-device call (wall, device time, launches, peak memory); K3b's
     launches and device ms in each sharded NTT
 28. (in phase 14, while the 512 MiB key is on the card) path `sh`: G1
     msm_sharded over the key's h_query (2^23 - 1 points) and G2 over its
     b_g2_query on 8 shards, seeded scalars, == the single-device msm;
     traced as phase 27
 29. K3b (csrc/ntt_rows.cu) at the four-step shapes of 2^23 on 8
     shards (256 transforms of 2^12, 512 of 2^11): one launch a batch,
     forward and inverse against the plain transform; its time, bound
     and share; then the edge shapes (one row, 2^1, stage counts that
     leave a radix-2 or radix-4 trip, more rows than the card holds
     blocks, 2^12 at the shared-memory limit) and a batch of rows of
     2^13, which K3's batched passes take, every row against the plain
     transform
 30. (after phase 15 and the second process) path `pm`:
     generate_window_post over four replicas of phase 5's sector (two
     partitions) under phase 18's cached key,
     through compound.prove and prove_many on every card; the same
     circuits through prove_many on a 2-shard mesh; both counted and
     traced; the bytes of both == the serial per-partition prove (on one
     card the every-card run is that loop), and the proof verifies; the
     every-card run synthesizes the circuits, so K7 must launch in it
 31. (after phase 16's thread has joined) path `sm`: seal_many of two
     512 MiB jobs with two labeling workers: job A (phase 5's data and
     replica id) == phase 5's comm_d, comm_c, comm_r_last, comm_r and
     replica; job B (another sector id): stored nodes == host Poseidon,
     comm_r == H(comm_c, comm_r_last); wall against twice phase 5's PC1
     + PC2, peak host and device memory
 32. (in the second process, after phase 25) path `wr`: the Poseidon
     witness replay, zk/gadgets/tiled.py `poseidon_witness_v` on cuda
     (K1, K7, the copies and the limb widening): the seeded batches of
     tests/torch_witness_ref.py == the frozen JAX digests
     (tests/golden/torch_witness.json); then, counts from 0, at arity 8
     on 23,490 instances (a 32 GiB Window PoSt partition's PoR level,
     2,349 sectors x 10 challenges), arity 2 on 2,349 (its sector
     headers) and arity 11 on 270 (a 32 GiB C2 partition's columns, 18
     challenges x 15): each call's wall and peak device memory; every
     row of K7 == its plain version on the card, each digest == K2's;
     K7's device time, bound and the plain version's time; the same
     checks and times at each batch size that C2 and the PoSt paths
     launch (`WITNESS_PATH_SHAPES`; the kernels line lists the sizes each
     of cm, wn, wd and pm launched, and every one must be among them)

The last line of standard output is
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
Any failure exits non-zero without it; so does a machine without CUDA.

Run:  python3 chip_smoke.py [--seed N]
(the script starts its second process itself, with --side)
"""
from __future__ import annotations

import argparse
import io
import json
import os
import pickle
import random
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

SECTOR_SIZE = 512 << 20  # registered class, shape (8, 0, 0), 2 layers
PROVER_ID = bytes([9] * 32)
TICKET = bytes([3] * 32)
SECTOR_ID = 5
POREP_ID = bytes([2] * 32)

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s, and 32-bit
# integer multiply-adds/s: 64 per SM per clock for compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput), half
# the fp32 FMA rate, times 132 SMs at 1.98 GHz. Phase 1 measures it.
PEAK_BYTES_PER_S = 3.35e12
PEAK_MAD32_PER_S = 64 * 132 * 1.98e9


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# 32x32->64-bit products of n-limb arithmetic: a product, a squaring
# (each cross term once) and a Montgomery reduction of a 2n-limb value
# (n quotient limbs, each times the n limbs of p)
def _mul(n: int) -> int:
    return n * n


def _sqr(n: int) -> int:
    return n * (n + 1) // 2


def _redc(n: int) -> int:
    return n * n + n


def montmul_mads(n32: int) -> int:
    """32-bit multiply-adds of one Montgomery product: a*b, then one
    reduction; each 32x32->64 product is a low and a high half."""
    return 2 * (_mul(n32) + _redc(n32))


def poseidon_mads(t: int, r_f: int, r_p: int, n32: int = 8) -> int:
    """32-bit multiply-adds that one permutation needs under the sparse
    schedule: x^5 as two squarings and a product, each reduced; a mixed
    element as its products summed wide and reduced once (t per dense
    row, t for out0 of a partial round, one for each w_i * x0)."""
    mul, redc = _mul(n32), _redc(n32)
    sbox = 2 * (_sqr(n32) + redc) + mul + redc
    row = t * mul + redc
    full = t * sbox + t * row
    partial = sbox + row + (t - 1) * (mul + redc)
    return 2 * (r_f * full + r_p * partial + t * row)


def ntt_products(log_n: int) -> int:
    """Montgomery products that a transform of 2^log_n elements needs:
    (n/2) log2 n butterflies, less the n - 1 of them at w^0 = 1."""
    n = 1 << log_n
    return n // 2 * log_n - (n - 1)


def bound_ms(nbytes: float, mads: float) -> tuple[float, str]:
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = mads / PEAK_MAD32_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over the u32 limbs of two int32 tensors."""
    mask = 0xFFFFFFFF
    diff = (got.long() & mask) - (want.long() & mask)
    return int(diff.abs().max()) if diff.numel() else 0


def rand_elems(field, n: int, gen) -> "torch.Tensor":
    """n canonical elements as int32 [n, n32] on the card, over all of
    [0, p): random values below 2^bits(p), those at or above p with their
    top bit cleared; then 0, 1 and p - 1 in rows 0-2."""
    import torch

    from crypto3_fil_proofs_torch.ops import field as F

    x = torch.randint(
        -(1 << 31), 1 << 31, (n, field.n32), dtype=torch.int32, device="cuda", generator=gen
    )
    top_bits = field.modulus.bit_length() - 32 * (field.n32 - 1)
    x[:, -1] &= (1 << top_bits) - 1  # value < 2^bits(p)
    # x >= p, decided by the highest limb where x and p differ
    u = x.long() & 0xFFFFFFFF
    ge = torch.ones(n, dtype=torch.bool, device="cuda")
    for k, pk in enumerate(field.p32):
        ge = torch.where(u[:, k] > pk, True, torch.where(u[:, k] < pk, False, ge))
    x[:, -1] = torch.where(ge, x[:, -1] & ((1 << (top_bits - 1)) - 1), x[:, -1])
    x[:3] = F.ints_to_limbs32([0, 1, field.modulus - 1], field).cuda()
    return x


def timed(fn):
    """(fn(), its device time in ms) for one call."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def check_equal(what: str, got, want) -> int:
    """Fail unless kernel and plain outputs are equal; their max_abs_err."""
    import torch

    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).any(dim=1).sum())
        raise AssertionError(f"{what}: {bad} of {got.shape[0]} outputs differ from the plain version")
    return max_abs_err(got, want)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build() -> None:
    from crypto3_fil_proofs_torch.ops.cuda import build

    t0 = time.time()
    build.build()
    log(f"phase 1: built {build.sources()} in {time.time() - t0:.1f} s")
    for name, report in sorted(build.ptxas_reports.items()):
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {name}: {line.strip()}")


def phase_k1(gen) -> dict:
    """K1 against its plain version: Fr at the path's largest shape (2^24
    leaves of a 512 MiB tree entering Montgomery form, b = R^2
    broadcast), Fr and Fq with a full b on 2^20 elements."""
    from crypto3_fil_proofs_torch.ops import field as F
    from crypto3_fil_proofs_torch.ops.cuda import field as k1

    out = {}
    x = rand_elems(F.FR, SECTOR_SIZE // 32, gen)
    r2 = F.ints_to_limbs32([F.FR.mont_r2])[0].cuda()
    want, plain_ms = timed(lambda: F.mont_mul32(x, r2))
    out["fr_path"] = (x, r2, check_equal("K1 Fr x R^2", k1.montmul(x, r2), want), plain_ms)
    log(f"phase 2: K1 Fr montmul == plain on {x.shape[0]} elements times R^2")
    del want
    for fld in (F.FR, F.FQ):
        a, b = rand_elems(fld, 1 << 20, gen), rand_elems(fld, 1 << 20, gen).flip(0)
        want, plain_ms = timed(lambda: F.mont_mul32(a, b, fld))
        out[fld.name] = (a, b, check_equal(f"K1 {fld.name}", k1.montmul(a, b, fld), want), plain_ms)
        log(f"phase 2: K1 {fld.name} montmul == plain on {a.shape[0]} pairs (0, 1, p-1 included)")
    return out


def k2_shapes() -> tuple:
    """(arity, states, stride of the plain check) of each K2 launch timed:
    one column batch at arity 2, the first level of a 512 MiB tree at
    arity 8, one column batch of a 32 GiB tree_c at arity 11."""
    from crypto3_fil_proofs_torch.core.settings import settings

    batch = settings().max_gpu_column_batch_size
    return (2, batch, 1), (8, SECTOR_SIZE // 32 // 8, 127), (11, batch, 61)


def phase_k2(gen) -> dict:
    """K2 at the path's shapes (one column batch at arity 2, the first
    level of a 512 MiB tree at arity 8, one column batch of a 32 GiB
    tree_c at arity 11), against the plain version on all rows (arity 2)
    or every 127th / 61st row (arity 8 / 11, where the plain version on
    all rows would not fit in device memory or time), and 16 digests
    against the host poseidon_hash. The strides are primes that divide
    neither the block (384 / 256 threads) nor the persistent grid, so the
    sample takes every thread of a block and every pass of the grid."""
    from crypto3_fil_proofs_torch.ops import field as F
    from crypto3_fil_proofs_torch.ops import poseidon_torch as PT
    from crypto3_fil_proofs_torch.ops.cuda import field as k1
    from crypto3_fil_proofs_torch.ops.cuda import poseidon as k2
    from crypto3_fil_proofs_torch.ops.poseidon import poseidon_hash

    out = {}
    for arity, n, stride in k2_shapes():
        pre = rand_elems(F.FR, n * arity, gen).reshape(n, arity, PT.L)
        got = k2.poseidon_hash(pre, arity)
        sub = pre[::stride].contiguous()
        want, plain_ms = timed(lambda: PT.hash_mont_plain(sub, arity))
        err = check_equal(f"K2 arity {arity}", got[::stride].contiguous(), want)
        # 16 digests against the host permutation (normal form in and out)
        values = F.limbs32_to_ints(k1.from_mont(pre[:16].reshape(-1, PT.L)))
        digests = F.limbs32_to_ints(k1.from_mont(got[:16]))
        for i in range(16):
            if digests[i] != poseidon_hash(values[i * arity : (i + 1) * arity], arity):
                raise AssertionError(f"K2 arity {arity}: digest {i} differs from the host poseidon_hash")
        out[arity] = (pre, sub, err, plain_ms)
        log(f"phase 3: K2 arity {arity} on {n} states == plain on {sub.shape[0]} of them; "
            "16 digests == host poseidon_hash")
    return out


def run_precommit(size: int, work: str, piece: bytes, device: str, keep_pc1: bool = False):
    """add_piece, PC1 and PC2 of one sector. With `keep_pc1`, a copy of
    PC1's replica is kept and the last value returned runs PC2 once more
    from it (PC2 encodes the replica in place), else it is None."""
    from crypto3_fil_proofs_torch.api import mod as api_mod
    from crypto3_fil_proofs_torch.api import seal as api_seal
    from crypto3_fil_proofs_torch.core.measure import measurements
    from crypto3_fil_proofs_torch.types import PoRepConfig

    config = PoRepConfig.for_sector_size(size, POREP_ID)
    os.makedirs(work)
    staged, sealed, cache = (os.path.join(work, n) for n in ("staged", "sealed", "cache"))
    times = {}
    t0 = time.time()
    info, _ = api_mod.add_piece(piece, staged, len(piece), [])
    times["add_piece_s"] = time.time() - t0
    t0 = time.time()
    p1 = api_seal.seal_pre_commit_phase1(
        config, cache, staged, sealed, PROVER_ID, SECTOR_ID, TICKET, [info], device=device
    )
    times["pc1_s"] = time.time() - t0
    if not api_mod.validate_cache_for_precommit_phase2(cache, sealed, config):
        raise AssertionError("phase-1 cache does not validate")
    if keep_pc1:
        shutil.copyfile(sealed, sealed + ".pc1")
    t0 = time.time()
    p2 = api_seal.seal_pre_commit_phase2(config, p1, cache, sealed, device=device)
    times["pc2_s"] = time.time() - t0
    m = measurements()
    times.update(
        {f"{k}_s": m[k] for k in ("comm_d", "generate_labels", "tree_c", "encode", "tree_r_last")}
    )
    with open(os.path.join(cache, "p_aux"), "rb") as f:
        paux = f.read()

    def pc2_again():
        os.replace(sealed + ".pc1", sealed)
        return api_seal.seal_pre_commit_phase2(config, p1, cache, sealed, device=device)

    return p2, paux, cache, sealed, times, pc2_again if keep_pc1 else None


def phase_parent_cache() -> float:
    """Phase 1, in a thread beside the kernel build: the 512 MiB graph's
    parent table into the run's parent cache, which phase 5's PC1 then
    maps (as a provider's later sectors of that graph do). Its time."""
    from crypto3_fil_proofs_torch.models.porep.stacked.vanilla.cache import ParentCache
    from crypto3_fil_proofs_torch.parameters import public_params
    from crypto3_fil_proofs_torch.types import PoRepConfig

    t0 = time.time()
    ParentCache(public_params(PoRepConfig.for_sector_size(SECTOR_SIZE, POREP_ID)).graph)
    return time.time() - t0


def phase_2k(work: str) -> dict:
    from crypto3_fil_proofs_torch.core.fr32 import to_unpadded_bytes

    with open(os.path.join(REPO, "tests", "golden", "torch_precommit_2k.json")) as f:
        golden = json.load(f)
    size = golden["sector_size"]
    piece = bytes((i * 37 + 11) % 256 for i in range(to_unpadded_bytes(size)))
    p2, paux, cache, sealed, _, _ = run_precommit(size, work, piece, "cuda")
    got = {
        "comm_d": p2.comm_d.hex(), "comm_c": paux[:32].hex(),
        "comm_r_last": paux[32:64].hex(), "comm_r": p2.comm_r.hex(),
    }
    for k, v in got.items():
        if v != golden[k]:
            raise AssertionError(f"2 KiB {k} {v} != JAX package's {golden[k]}")
    log(f"phase 4: 2 KiB pre-commit on cuda == JAX package: comm_r {p2.comm_r.hex()}")
    return {"p2": p2, "cache": cache, "sealed": sealed}


def _level_offsets(leafs: int, arity: int) -> list[tuple[int, int]]:
    """(offset, size) of each level of a linear-layout tree, leaves first."""
    out, off, n = [], 0, leafs
    while True:
        out.append((off, n))
        if n == 1:
            return out
        off += n
        n //= arity


def _check_tree_nodes(path: str, leafs: int, arity: int, rng: random.Random, count: int) -> None:
    import numpy as np

    from crypto3_fil_proofs_torch.ops.poseidon import poseidon_hash

    levels = _level_offsets(leafs, arity)
    mm = np.memmap(path, dtype=np.uint8, mode="r").reshape(-1, 32)
    for _ in range(count):
        lvl = rng.randrange(1, len(levels))
        off, n = levels[lvl]
        coff, _ = levels[lvl - 1]
        j = rng.randrange(n)
        kids = [int.from_bytes(mm[coff + arity * j + c].tobytes(), "little") for c in range(arity)]
        want = poseidon_hash(kids, arity).to_bytes(32, "little")
        if mm[off + j].tobytes() != want:
            raise AssertionError(f"{os.path.basename(path)}: node {off + j} (level {lvl}) != host Poseidon")


def phase_512(work: str, seed: int) -> dict:
    import numpy as np
    import torch

    from crypto3_fil_proofs_torch.ops.poseidon import hash2, poseidon_hash

    size = SECTOR_SIZE
    piece = staged_piece(seed).tobytes()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the kernel checks' tensors
    # the main path: counts from 0 just before it, read just after it
    reset_counts()
    p2, paux, cache, sealed, times, pc2_again = run_precommit(size, work, piece, "cuda", keep_pc1=True)
    torch_sync()
    counts = all_counts()
    launches = {k: counts[k] for k in ("fr_montmul", "poseidon_a2", "poseidon_a8")}
    off_path = {k: counts[k] for k in ("fq_montmul", "poseidon_a11")}
    peak_all = torch.cuda.max_memory_allocated()
    peak = peak_all - held
    log(f"phase 5: {size} B pre-commit on cuda: comm_d {p2.comm_d.hex()} comm_r {p2.comm_r.hex()}")
    log("  times " + json.dumps({k: round(v, 3) for k, v in times.items()}))
    log(f"  launches {json.dumps(launches)} (off the path: {json.dumps(off_path)}); "
        f"max_memory_allocated {peak_all} B, of which the path {peak} B")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    rng = random.Random(seed)
    nodes = size // 32
    _check_tree_nodes(os.path.join(cache, "sc-02-data-tree-r-last.dat"), nodes, 8, rng, 64)
    _check_tree_nodes(os.path.join(cache, "sc-02-data-tree-c.dat"), nodes, 8, rng, 64)
    tree_c = np.memmap(os.path.join(cache, "sc-02-data-tree-c.dat"), dtype=np.uint8, mode="r").reshape(-1, 32)
    layers = [
        np.memmap(os.path.join(cache, f"sc-02-data-layer-{l}.dat"), dtype=np.uint8, mode="r").reshape(-1, 32)
        for l in (1, 2)
    ]
    for _ in range(64):
        i = rng.randrange(nodes)
        col = [int.from_bytes(layer[i].tobytes(), "little") for layer in layers]
        if poseidon_hash(col, 2).to_bytes(32, "little") != tree_c[i].tobytes():
            raise AssertionError(f"column hash of node {i} != host Poseidon")
    want_r = hash2(int.from_bytes(paux[:32], "little"), int.from_bytes(paux[32:64], "little"))
    if want_r.to_bytes(32, "little") != p2.comm_r:
        raise AssertionError("comm_r != H(comm_c, comm_r_last)")
    log("  64 tree_r_last nodes, 64 tree_c nodes and 64 column hashes == host Poseidon; "
        "comm_r == H(comm_c, comm_r_last)")
    # after the checks of the main path's output: PC2 once more, traced
    del tree_c, layers
    traced = trace_device(pc2_again)
    with open(os.path.join(cache, "p_aux"), "rb") as f:
        if f.read() != paux:
            raise AssertionError("the traced PC2 wrote other commitments")
    log_trace("PC2", traced)
    return {"launches": {**launches, **off_path}, "times": times, "peak_bytes": peak, "trace": traced,
            "p2": p2, "cache": cache, "sealed": sealed, "staged": os.path.join(work, "staged")}


def phase_kernels(k1_runs: dict, k2_runs: dict, launches: dict) -> list[dict]:
    """Each path kernel's time at the path's shape beside its plain
    version's (timed in the comparison of phases 2-3) and its bound."""
    from crypto3_fil_proofs_torch.ops import field as F
    from crypto3_fil_proofs_torch.ops import poseidon_torch as PT
    from crypto3_fil_proofs_torch.ops.cuda import field as k1
    from crypto3_fil_proofs_torch.ops.cuda import poseidon as k2

    x, r2, err, plain_ms = k1_runs["fr_path"]
    n = x.shape[0]
    b_ms, b_by = bound_ms(n * 64 + 32, n * montmul_mads(F.FR.n32))
    rows = [{
        "name": "fr_montmul", "route": "cuda",
        "source": "crypto3_fil_proofs_torch/csrc/field.cu",
        "replaces": "crypto3_fil_proofs_tpu/ops/pallas/field.py:113",
        "launches": launches["fr_montmul"], "n": n, "max_abs_err": err,
        "ms": cuda_ms(lambda: k1.montmul(x, r2), 20), "plain_ms": plain_ms, "plain_n": n,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }]
    for arity in (2, 8):
        pre, sub, err, plain_ms = k2_runs[arity]
        st = PT.staged(arity)
        n = pre.shape[0]
        mads = n * poseidon_mads(st.t, st.r_f, st.r_p)
        b_ms, b_by = bound_ms(n * (arity + 1) * 32, mads)
        rows.append({
            "name": f"poseidon_a{arity}", "route": "cuda",
            "source": "crypto3_fil_proofs_torch/csrc/poseidon.cu",
            "replaces": "crypto3_fil_proofs_tpu/ops/pallas/poseidon.py:613",
            "launches": launches[f"poseidon_a{arity}"], "n": n, "max_abs_err": err,
            "ms": cuda_ms(lambda: k2.poseidon_hash(pre, arity), 3),
            "plain_ms": plain_ms, "plain_n": sub.shape[0],
            "ms_at_plain_n": cuda_ms(lambda: k2.poseidon_hash(sub, arity), 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    # off the path, built and checked all the same: Fq and arity 11 (the
    # 32 GiB tree_c launch)
    a, b, err, plain_ms = k1_runs[F.FQ.name]
    n = a.shape[0]
    b_ms, b_by = bound_ms(n * 144, n * montmul_mads(F.FQ.n32))
    rows.append({
        "name": "fq_montmul", "route": "cuda", "source": "crypto3_fil_proofs_torch/csrc/field.cu",
        "replaces": "crypto3_fil_proofs_tpu/ops/pallas/field.py:113", "launches": launches["fq_montmul"],
        "n": n, "max_abs_err": err, "ms": cuda_ms(lambda: k1.montmul(a, b, F.FQ), 20),
        "plain_ms": plain_ms, "plain_n": n, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    })
    pre, sub, err, plain_ms = k2_runs[11]
    st = PT.staged(11)
    n = pre.shape[0]
    b_ms, b_by = bound_ms(n * 12 * 32, n * poseidon_mads(st.t, st.r_f, st.r_p))
    rows.append({
        "name": "poseidon_a11", "route": "cuda", "source": "crypto3_fil_proofs_torch/csrc/poseidon.cu",
        "replaces": "crypto3_fil_proofs_tpu/ops/pallas/poseidon.py:613", "launches": launches["poseidon_a11"],
        "n": n, "max_abs_err": err, "ms": cuda_ms(lambda: k2.poseidon_hash(pre, 11), 3),
        "plain_ms": plain_ms, "plain_n": sub.shape[0],
        "ms_at_plain_n": cuda_ms(lambda: k2.poseidon_hash(sub, 11), 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    })
    return rows


# ---------------------------------------------------------------------------
# the Groth16 path (phases 1b, 7-12)
# ---------------------------------------------------------------------------

DEVICE = "cuda"  # the device of phases 7-11 (a rehearsal on the CPU sets "cpu")
LOG_N = 19  # QAP domain of Winning PoSt over a 32 GiB sector
# the port's blank Winning PoSt circuit over a 32 GiB sector (66
# challenges, tree (8, 8, 0)): phase 11 synthesizes it and fails where its
# counts differ from these (kernel_times.py reads MSM_POINTS)
N_CONSTRAINTS = 282_191
N_VARS = 286_814  # the constant 1 and the inputs included
N_INPUTS = 68  # the constant 1, comm_r and 66 packed challenge indices
DISTINCT = 4096  # distinct bases of the synthetic key, tiled
PLAIN_MSM_N = 4096  # the plain MSM's subsample
PLAIN_LANES = 1 << 16  # the plain point ops' subsample of 2^19 lanes
# MSM sizes: G1 at the h query's (n - 1 coefficients), G2 at the B query's
MSM_POINTS = {"g1": (1 << LOG_N) - 1, "g2": N_VARS}

# Fq / Fr products each function needs (squarings of Fq2 as two Fq
# products): K4 madd_nodbl 7M + 4S, dbl 2M + 5S, add 11M + 5S; madd is
# madd_nodbl where P != Q (the doubling on the rare P == Q lanes instead)
CURVE_PRODUCTS = {
    "g1": {"madd_nodbl": 11, "madd": 11, "dbl": 7, "add": 16},
    "g2": {"madd_nodbl": 7 * 3 + 4 * 2, "dbl": 2 * 3 + 5 * 2, "add": 11 * 3 + 5 * 2},
}


def phase_rate_probe() -> dict:
    """32-bit multiply-adds per second, from chains of independent IMADs
    (and of 32 x 32 -> 64-bit multiply-adds) filling the card."""
    import ctypes

    import torch

    from crypto3_fil_proofs_torch.ops.cuda import build

    fn = build.load("imad_probe").imad_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = sms * 16, 256, 8192
    out = torch.empty(blocks * threads, dtype=torch.int32, device=DEVICE)
    rates = {}
    for wide in (0, 1):
        def run():
            err = fn(out.data_ptr(), 0x9E3779B1, 12345, iters, blocks, threads, wide,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"imad_probe failed: cudaError {err}")
        ms = cuda_ms(run, 5)
        rates["mad32_wide_per_s" if wide else "mad32_per_s"] = blocks * threads * iters * 8 / (ms * 1e-3)
    rates["sms"] = sms
    log(f"phase 1: 32-bit integer multiply-adds {rates['mad32_per_s']:.4e}/s "
        f"(32x32->64: {rates['mad32_wide_per_s']:.4e}/s) on {sms} SMs; the bound uses "
        f"{PEAK_MAD32_PER_S:.4e}/s")
    return rates


def ptxas_entries(reports=None) -> dict:
    """{entry function: (registers, spill stores, spill loads, stack)}
    from ptxas -v reports, by default those of the build."""
    import re

    from crypto3_fil_proofs_torch.ops.cuda import build

    out = {}
    for report in build.ptxas_reports.values() if reports is None else reports:
        name = props = None
        stack = spill_st = spill_ld = 0
        for line in report.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                name, props = m.group(1), None
                stack = spill_st = spill_ld = 0
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                props = m.group(1)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and name and props == name:
                stack, spill_st, spill_ld = (int(v) for v in m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out[name] = (int(m.group(1)), spill_st, spill_ld, stack)
                name = None
    return out


def registers(entries: dict, kernel: str, *parts: str) -> str | None:
    """'registers / spill bytes' of the entry function `kernel` whose
    mangled name also holds every part (such as a template argument,
    "I4fq_t"). The name is matched with its length prefix, so that
    dbl_kernel does not match madd_nodbl_kernel."""
    for name, (regs, st, ld, stack) in entries.items():
        if name.startswith(f"_Z{len(kernel)}{kernel}") and all(p in name for p in parts):
            return f"{regs} / {st} B spilled ({stack} B stack)"
    return None


def rand_fr_mont(n: int, gen):
    """n random Fr elements in Montgomery form, int32 [n, 8] on the card."""
    from crypto3_fil_proofs_torch.ops import field as F
    from crypto3_fil_proofs_torch.ops.cuda import field as k1

    return k1.to_mont(rand_elems(F.FR, n, gen))


def k3_device_ms(fn, reps: int) -> float | None:
    """device_ms of K3's passes in fn(), each launched on its own: a pass
    launched behind the one before it (ops/cuda/ntt.py PDL) counts its
    wait for that one in its kernel time."""
    from crypto3_fil_proofs_torch.ops.cuda import ntt as k3

    k3.PDL = False
    try:
        return device_ms(fn, TRACE_NAMES["ntt"], reps)
    finally:
        k3.PDL = True


# K3's domains on the paths (wd, wn, pv, dg, cm); phase 7 checks all but
# the commit's 2^23 against the plain transform (phase 27 holds that one
# against ntt_sharded) and the h pipeline at H_DOMAINS
NTT_DOMAINS = (17, 18, 19, 21, 23)
H_DOMAINS = (17, 19)


def phase_ntt(gen) -> dict:
    """K3 at the paths' domains up to 2^21 and on single vectors of 2^1 ..
    2^13, forward and inverse, the coset transforms, and the batched
    h_from_evals at H_DOMAINS, against the plain versions; K3m at the
    path's 2^19. Times and bounds of K3 at each domain."""
    import torch

    from crypto3_fil_proofs_torch.ops import field as F
    from crypto3_fil_proofs_torch.ops import ntt as N
    from crypto3_fil_proofs_torch.ops.cuda import field as k1
    from crypto3_fil_proofs_torch.ops.cuda import ntt as k3

    n = 1 << LOG_N
    a, b, c = (rand_fr_mont(n, gen) for _ in range(3))
    out = {"n": n, "domains": {}}
    for lg in NTT_DOMAINS[:-1]:
        x = a if lg == LOG_N else rand_fr_mont(1 << lg, gen)
        got = k3.transform(x, lg, False)
        want, plain_ms = timed(lambda: N.transform_plain(x, lg, False))
        err = check_equal(f"K3 forward 2^{lg}", got, want)
        del got, want
        err = max(err, check_equal(f"K3 inverse 2^{lg}", k3.transform(x, lg, True), N.transform_plain(x, lg, True)))
        # events around small transforms carry the host's launches: the kernels' own time is the profiler's
        out["domains"][lg] = {"ms": cuda_ms(lambda: k3.transform(x, lg, False), 20),
                              "device_ms": k3_device_ms(lambda: k3.transform(x, lg, False), 20),
                              "plain_ms": plain_ms, "max_abs_err": err, "passes": k3.plan(lg, 1, DEVICE),
                              "radix_log": k3.radix_log(1 << lg, torch.device(DEVICE))}
        del x
    out["plain_ms"], out["err"], out["ms"] = (out["domains"][LOG_N][k] for k in ("plain_ms", "max_abs_err", "ms"))
    for lg in range(1, 14):
        x = rand_fr_mont(max(1 << lg, 3), gen)[: 1 << lg]
        for inverse in (False, True):
            check_equal(f"K3 {'inverse' if inverse else 'forward'} 2^{lg}", k3.transform(x, lg, inverse),
                        N.transform_plain(x, lg, inverse))
    check_equal("K3 coset_ntt", k3.coset_ntt(b, LOG_N), N.coset_ntt(b, LOG_N))
    check_equal("K3 coset_intt", k3.coset_intt(b, LOG_N), N.coset_intt(b, LOG_N))
    check_equal("K3 intt(ntt)", k3.intt(k3.ntt(c, LOG_N), LOG_N), c)
    for lg in H_DOMAINS:
        ha, hb, hc = (v[: 1 << lg] for v in (a, b, c))
        h = k3.h_from_evals(ha, hb, hc, lg)
        # the plain h pipeline: plain transforms, plain products and sub, one vector at a time
        dev = str(a.device)
        cos = [N.transform_plain(F.mont_mul32(N.transform_plain(v, lg, True), N.table(lg, "h_in_scale", dev)),
                                 lg, False) for v in (ha, hb, hc)]
        num = F.sub32(F.mont_mul32(cos[0], cos[1]), cos[2])
        want_h = F.mont_mul32(N.transform_plain(num, lg, True), N.table(lg, "h_out_scale", dev))
        del cos, num
        check_equal(f"h_from_evals 2^{lg}", h, want_h)
        del h, want_h
    want_sub, out["sub_plain_ms"] = timed(lambda: F.sub32(a, b))
    out["sub_err"] = check_equal("K1 fr_sub", k1.sub(a, b), want_sub)
    want_mul, out["mul_plain_ms"] = timed(lambda: F.mont_mul32(a, b))
    out["mul_err"] = check_equal("K1 fr_montmul (h path)", k1.montmul(a, b), want_mul)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out["h_ms"] = cuda_ms(lambda: k3.h_from_evals(a, b, c, LOG_N), 5)
    out["h_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    out["sub_ms"] = cuda_ms(lambda: k1.sub(a, b), 20)
    out["mul_ms"] = cuda_ms(lambda: k1.montmul(a, b), 20)
    # a loop of these 20 us launches is paced by the host: the kernel's
    # own time is the profiler's
    out["sub_device_ms"] = device_ms(lambda: k1.sub(a, b), TRACE_NAMES["fr_sub"])
    out["mul_device_ms"] = device_ms(lambda: k1.montmul(a, b), TRACE_NAMES["fr_montmul"])
    # the last pass (strided groups) on a vector that is in L2 (just
    # written) and on one that a 256 MiB write has pushed out of it
    x = k3.transform(a, LOG_N, False)
    last = k3.plan(LOG_N, 1, DEVICE)[-1]
    outer = lambda: k3.run_pass(x, x, LOG_N, *last, False)
    out["outer_pass_warm_ms"] = cuda_ms(outer, 20)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=DEVICE)
    cold = []
    for _ in range(10):
        flush.fill_(1)
        cold.append(timed(outer)[1])
    out["outer_pass_cold_ms"] = sum(cold) / len(cold)
    del flush, x
    times = ", ".join(f"2^{lg} {d['ms']:.4f} ms ({d['device_ms'] or float('nan'):.4f} of kernels)"
                      for lg, d in out["domains"].items())
    log(f"phase 7: K3 forward and inverse == plain at 2^{', 2^'.join(map(str, out['domains']))} and on single "
        f"vectors of 2^1 .. 2^13; coset transforms at 2^{LOG_N}; the batched h_from_evals == the plain chain at "
        f"2^{', 2^'.join(map(str, H_DOMAINS))}; K1 fr_sub and fr_montmul == plain; transform {times}; h pipeline "
        f"{out['h_ms']:.4f} ms (peak {out['h_peak_bytes']} B above its inputs); last pass "
        f"{out['outer_pass_warm_ms']:.4f} ms from L2, {out['outer_pass_cold_ms']:.4f} ms after a flush")
    torch.cuda.empty_cache()
    return out


# lanes of edge_block where each run of its six edge cases starts: the
# first lanes of a block, the last lanes of one, and the last lanes of one
# running into a lone lane in the last block (K4 runs 128 lanes a block,
# K5 32; a warp holds 32 lanes of K4 and 16 of K5, whose every position
# gets a case)
EDGE_AT = (0, 6, 122, 251)
EDGE_LANES = 257


def edge_block(curve, seed: int):
    """(acc Jacobian, q affine, valid) on EDGE_LANES lanes with every edge
    case at each offset o of EDGE_AT: lane o acc at infinity, o + 1
    q == acc, o + 2 q == -acc, o + 3 masked, o + 4 acc at infinity and
    masked, o + 5 q == acc in another Jacobian scale; the rest generic
    pairs of known-log points, acc with Z != 1."""
    import torch

    from crypto3_fil_proofs_torch.ops import msm as M
    from crypto3_fil_proofs_torch.ops.bls12_381 import P

    n = EDGE_LANES
    pts, _ = M.random_walk_bases(curve, 2 * n, seed)
    two = curve.host_double(pts[0])
    acc_h = [curve.host_add(p, two) for p in pts[:n]]
    q_h = list(pts[n:])
    valid = torch.ones(n, dtype=torch.bool)
    for o in EDGE_AT:
        acc_h[o] = acc_h[o + 4] = curve.host_inf
        q_h[o + 1] = acc_h[o + 1]
        x, y = curve.to_affine(acc_h[o + 2])
        q_h[o + 2] = (x, (-y) % P if curve.name == "g1" else ((-y[0]) % P, (-y[1]) % P))
        q_h[o + 5] = acc_h[o + 5]
        valid[[o + 3, o + 4]] = False
    acc = curve.encode_coords([c for p in acc_h for c in p]).reshape((n, 3) + curve.coord)
    q, _ = curve.points_to_device(q_h)
    return acc.to(DEVICE), q.to(DEVICE), valid.to(DEVICE)


def sum_points_sizes(n: int) -> list[int]:
    """Lane counts of ops/msm.py `sum_points` over n points: its
    madd_nodbl, then each add of the halving tree."""
    h = n // 2
    sizes = [h]
    m = h + n % 2
    while m > 1:
        m += m % 2
        m //= 2
        sizes.append(m)
    return sizes


def random_lanes(curve, kern, n: int, seed: int):
    """(acc, q, valid) on n lanes: tiled known-log bases, acc one kernel
    madd away from a lifted base (so Z != 1), valid random."""
    import torch

    from crypto3_fil_proofs_torch.ops import msm as M

    bases, _ = M.random_walk_bases(curve, DISTINCT, seed)
    aff, _ = curve.points_to_device(bases)
    aff = aff.to(DEVICE)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    idx = [torch.randint(0, DISTINCT, (n,), device=DEVICE, generator=g) for _ in range(3)]
    acc, _ = kern.madd_nodbl(curve.lift(aff[idx[0]]), aff[idx[1]], torch.ones(n, dtype=torch.bool, device=DEVICE))
    valid = torch.rand(n, device=DEVICE, generator=g) < 0.9
    return acc, aff[idx[2]].contiguous(), valid


def phase_curves(seed: int) -> dict:
    """K4 and K5's entry points against their plain versions on an edge
    block (every lane), on 2^19 lanes (the first 2^16 compared) and, on
    the same lanes, at each lane count of the prove path's scalar-1 sums
    (every lane)."""
    import numpy as np
    import torch

    from crypto3_fil_proofs_torch.ops.cuda import g1 as k4
    from crypto3_fil_proofs_torch.ops.cuda import g2 as k5

    ones = sum(1 for w in prove_witness(np.random.default_rng(seed + 31)) if w == 1)
    tree = sum_points_sizes(ones)
    runs = {}
    n = 1 << LOG_N
    flat = lambda t: t.reshape(t.shape[0], -1)
    for kern in (k4.K4, k5.K5):
        curve = kern.curve
        acc, q, valid = edge_block(curve, seed)
        out, same = kern.madd_nodbl(acc, q, valid)
        want, want_same = curve.madd_nodbl_plain(acc, q, valid)
        check_equal(f"{curve.name} madd_nodbl (edges)", flat(out), flat(want))
        expect = [o + k for o in EDGE_AT for k in (1, 5)]
        if not torch.equal(same, want_same) or same.nonzero().flatten().tolist() != expect:
            raise AssertionError(f"{curve.name} madd_nodbl: same flags {same.nonzero().flatten().tolist()}")
        d = kern.dbl(out, same)
        check_equal(f"{curve.name} dbl (edges)", flat(d), flat(curve.dbl_plain(want, want_same)))
        if "madd" in kern.ops:
            m = kern.madd(acc, q, valid)
            check_equal(f"{curve.name} madd (edges)", flat(m), flat(curve.madd_plain(acc, q, valid)))
        p2 = torch.cat([acc[1:], acc[:1]])
        for o in EDGE_AT:
            p2[o + 5] = out[o + 5]
        a = kern.add(acc, p2)
        check_equal(f"{curve.name} add (edges)", flat(a), flat(curve.add_plain(acc, p2)))
        # 2^19 lanes: kernel on all, plain on the first PLAIN_LANES
        acc, q, valid = random_lanes(curve, kern, n, seed + 7)
        sub = slice(0, PLAIN_LANES)
        row = {"n": n, "plain_n": PLAIN_LANES, "odd_sizes": tree}
        out, same = kern.madd_nodbl(acc, q, valid)
        (want, want_same), row["madd_nodbl_plain_ms"] = timed(
            lambda: curve.madd_nodbl_plain(acc[sub], q[sub], valid[sub]))
        row["madd_nodbl_err"] = check_equal(f"{curve.name} madd_nodbl", flat(out[sub]), flat(want))
        if not torch.equal(same[sub], want_same):
            raise AssertionError(f"{curve.name} madd_nodbl: same flags differ from the plain version")
        every = torch.ones(n, dtype=torch.bool, device=DEVICE)
        d = kern.dbl(out, every)
        want_d, row["dbl_plain_ms"] = timed(lambda: curve.dbl_plain(out[sub], every[sub]))
        row["dbl_err"] = check_equal(f"{curve.name} dbl", flat(d[sub]), flat(want_d))
        s = kern.add(out, d)
        want_s, row["add_plain_ms"] = timed(lambda: curve.add_plain(out[sub], d[sub]))
        row["add_err"] = check_equal(f"{curve.name} add", flat(s[sub]), flat(want_s))
        ops = ["madd_nodbl", "dbl", "add"]
        if "madd" in kern.ops:
            # q == acc on every 64th lane, so the doubling path runs too
            q2 = q.clone()
            q2[::64] = curve.normalize(acc[::64])[0]
            mk = kern.madd(acc, q2, valid)
            want_m, row["madd_plain_ms"] = timed(lambda: curve.madd_plain(acc[sub], q2[sub], valid[sub]))
            row["madd_err"] = check_equal(f"{curve.name} madd", flat(mk[sub]), flat(want_m))
            ops.append("madd")
        # the scalar-1 sums' lane counts on the first lanes of the same
        # inputs; the plain outputs are those of the first PLAIN_LANES
        for m in tree:
            if m > PLAIN_LANES:
                raise AssertionError(f"a sum of {m} lanes is past the plain check's {PLAIN_LANES}")
            o, sm = kern.madd_nodbl(acc[:m], q[:m], valid[:m])
            check_equal(f"{curve.name} madd_nodbl ({m} lanes)", flat(o), flat(want[:m]))
            if not torch.equal(sm, want_same[:m]):
                raise AssertionError(f"{curve.name} madd_nodbl ({m} lanes): same flags differ")
            check_equal(f"{curve.name} dbl ({m} lanes)", flat(kern.dbl(out[:m], every[:m])), flat(want_d[:m]))
            check_equal(f"{curve.name} add ({m} lanes)", flat(kern.add(out[:m], d[:m])), flat(want_s[:m]))
            if "madd" in kern.ops:
                check_equal(f"{curve.name} madd ({m} lanes)", flat(kern.madd(acc[:m], q2[:m], valid[:m])),
                            flat(want_m[:m]))
        row["madd_nodbl_ms"] = cuda_ms(lambda: kern.madd_nodbl(acc, q, valid), 10)
        row["dbl_ms"] = cuda_ms(lambda: kern.dbl(out, every), 10)
        if "madd" in kern.ops:
            row["madd_ms"] = cuda_ms(lambda: kern.madd(acc, q2, valid), 10)
            del mk, q2
        # three readings of the add, to show their spread
        adds = [cuda_ms(lambda: kern.add(out, d), 10) for _ in range(3)]
        row["add_ms"], row["add_ms_readings"] = min(adds), adds
        runs[curve.name] = row
        log(f"phase 8: {curve.name} {', '.join(ops)} == plain on the edge block ({EDGE_LANES} lanes, "
            f"cases at {list(EDGE_AT)}), on {PLAIN_LANES} of {n} lanes and at every lane of the "
            f"scalar-1 sums' {len(tree)} lane counts {tree[:3]}...; ms "
            + " / ".join(f"{row[op + '_ms']:.4f}" for op in ops) + f"; add readings {json.dumps(adds)}")
        del acc, q, valid, out, same, d, s
        torch.cuda.empty_cache()
    return runs


def known_log_msm_input(curve, n: int, seed: int):
    """n affine points tiled from DISTINCT known-log bases (on the card),
    their logs, and the base indices."""
    import torch

    from crypto3_fil_proofs_torch.ops import msm as M

    bases, logs = M.random_walk_bases(curve, DISTINCT, seed)
    aff, _ = curve.points_to_device(bases)
    idx = torch.arange(n) % DISTINCT
    return aff.to(DEVICE)[idx.to(DEVICE)].contiguous(), logs, idx.tolist()


def exponent(curve, k: int):
    from crypto3_fil_proofs_torch.ops import bls12_381 as B

    if curve.name == "g1":
        return B.g1_mul(B.g1_from_affine(B.G1_GEN), k)
    return B.g2_mul(B.g2_from_affine((B.G2_GEN_X, B.G2_GEN_Y)), k)


def uniform_scalars(n: int, rng) -> list[int]:
    from crypto3_fil_proofs_torch.ops.bls12_381 import R

    raw = rng.integers(0, 256, (n, 32), dtype="uint8").tobytes()
    return [int.from_bytes(raw[32 * i : 32 * i + 32], "little") % R for i in range(n)]


def phase_msm(seed: int) -> dict:
    """K6: a G1 MSM at the h query's size and a G2 MSM at the B query's,
    over tiled known-log bases, against (sum s_i k_i) G; the plain MSM
    on a 4096-point subsample against the kernel on the same points."""
    import numpy as np
    import torch

    from crypto3_fil_proofs_torch.ops import field as F
    from crypto3_fil_proofs_torch.ops import msm as M
    from crypto3_fil_proofs_torch.ops.bls12_381 import R
    from crypto3_fil_proofs_torch.ops.g1_torch import G1
    from crypto3_fil_proofs_torch.ops.g2_torch import G2

    rng = np.random.default_rng(seed)
    runs = {}
    for curve in (G1, G2):
        n = MSM_POINTS[curve.name]
        aff, logs, idx = known_log_msm_input(curve, n, seed + 11)
        scalars = uniform_scalars(n, rng)
        scalars[:4] = [0, 1, R - 1, 1]
        s = F.ints_to_limbs32(scalars).to(DEVICE)
        torch.cuda.synchronize()
        t0 = time.time()
        got = M.msm(curve, aff, s)
        wall = time.time() - t0
        want = exponent(curve, sum(k * logs[i] for k, i in zip(scalars, idx)) % R)
        if curve.to_affine(got) != curve.to_affine(want):
            raise AssertionError(f"{curve.name} MSM of {n} points != (sum s_i k_i) G")
        # the device part alone (no split, no host combine), and its work
        bits = M.scalar_bits(s)
        c = M.window_bits(n, bits)
        windows = -(-bits // c)
        sched = M.schedule(s, c, windows)
        row = {
            "n": n, "c": c, "windows": windows, "wall_s": wall, "madds": sched.madds,
            "buckets": windows << c,
            "ms": cuda_ms(lambda: M.pippenger(curve, aff, s, c), 2),
        }
        # the plain MSM on a subsample, and the kernel on the same points
        sa, ss = aff[:PLAIN_MSM_N].contiguous(), s[:PLAIN_MSM_N].contiguous()
        plain_c = M.window_bits(PLAIN_MSM_N)
        (want_sub, _), row["plain_ms"] = timed(lambda: M.pippenger(curve, sa, ss, plain_c, plain=True))
        got_sub = M.pippenger(curve, sa, ss, plain_c)[0]
        row["plain_n"] = PLAIN_MSM_N
        row["err"] = check_equal(f"{curve.name} MSM window totals ({PLAIN_MSM_N} points)",
                                 got_sub.reshape(got_sub.shape[0], -1), want_sub.reshape(got_sub.shape[0], -1))
        row["ms_at_plain_n"] = cuda_ms(lambda: M.pippenger(curve, sa, ss, plain_c), 3)
        runs[curve.name] = row
        log(f"phase 9: {curve.name} MSM of {n} points == (sum s_i k_i) G (c = {c}, {windows} windows, "
            f"{sched.madds} bucket adds, wall {wall:.3f} s, device {row['ms']:.3f} ms); "
            f"window totals == plain on {PLAIN_MSM_N} points")
        del aff, s, sched
        torch.cuda.empty_cache()
    return runs


def cubic_cs(out_value: int):
    from crypto3_fil_proofs_torch.zk.gadgets.num import AllocatedNum
    from crypto3_fil_proofs_torch.zk.r1cs import ConstraintSystem, LinearCombination, lc_one

    cs = ConstraintSystem()
    xn = AllocatedNum.alloc(cs, 3)
    x3 = xn.square(cs).mul(cs, xn)
    out = AllocatedNum.alloc_input(cs, out_value)
    cs.enforce(x3.lc() + xn.lc() + LinearCombination.constant(5), lc_one(), out.lc(), "out")
    return cs


def phase_cubic() -> None:
    import numpy as np

    from crypto3_fil_proofs_torch.zk import groth16

    with np.load(os.path.join(REPO, "tests", "golden", "torch_groth16_cubic.npz")) as g:
        golden = {k: g[k] for k in g.files}
    pk = groth16.proving_key_from_jax(golden)
    out = int(golden["public_output"])
    for rnd in ("fixed", "other"):
        proof = groth16.prove(pk, cubic_cs(out), randomness=rnd.encode(), device=DEVICE)
        if proof.to_bytes() != golden[f"proof_{rnd}"].tobytes():
            raise AssertionError(f"cubic proof ({rnd}) on cuda != the JAX package's bytes")
        if not groth16.verify(pk.vk, proof, [out]) or groth16.verify(pk.vk, proof, [out + 1]):
            raise AssertionError(f"cubic proof ({rnd}): verify does not accept / reject as it should")
    log("phase 10: cubic proofs on cuda == the JAX package's bytes (b'fixed', b'other'); verify accepts")


def synthetic_key(seed: int):
    """A proving key of the Winning PoSt size whose every point is a
    known multiple of its generator; returns (key, logs of each query,
    (alpha, beta, delta))."""
    import numpy as np
    import torch

    from crypto3_fil_proofs_torch.ops import bls12_381 as B
    from crypto3_fil_proofs_torch.ops import msm as M
    from crypto3_fil_proofs_torch.ops.g1_torch import G1
    from crypto3_fil_proofs_torch.ops.g2_torch import G2
    from crypto3_fil_proofs_torch.zk import groth16

    rng = np.random.default_rng(seed)
    alpha, beta, gamma, delta = (int(v) for v in rng.integers(1, 1 << 62, 4))
    tables = {}
    for curve, s in ((G1, seed + 21), (G2, seed + 22)):
        bases, logs = M.random_walk_bases(curve, DISTINCT, s)
        tables[curve.name] = (curve.points_to_device(bases)[0], logs)
    m = 1 << LOG_N
    layout = {  # query: (group, length, index multiplier, offset)
        "a_query": ("g1", N_VARS, 1, 0),
        "b_g1_query": ("g1", N_VARS, 3, 7),
        "b_g2_query": ("g2", N_VARS, 5, 11),
        "h_query": ("g1", m - 1, 7, 13),
        "l_query": ("g1", N_VARS - N_INPUTS, 11, 17),
    }
    queries, logs = {}, {}
    for q, (g, n, mult, off) in layout.items():
        aff, base_logs = tables[g]
        idx = (torch.arange(n) * mult + off) % DISTINCT
        queries[q] = (aff[idx].contiguous(), torch.ones(n, dtype=torch.bool))
        logs[q] = [base_logs[i] for i in idx.tolist()]
    g1, g2 = B.g1_from_affine(B.G1_GEN), B.g2_from_affine((B.G2_GEN_X, B.G2_GEN_Y))
    vk = groth16.VerifyingKey(B.g1_mul(g1, alpha), B.g2_mul(g2, beta), B.g2_mul(g2, gamma),
                              B.g2_mul(g2, delta), [g1] * N_INPUTS)
    pk = groth16.ProvingKey(vk, B.g1_mul(g1, beta), B.g1_mul(g1, delta), log_n=LOG_N, **queries)
    return pk, logs, (alpha, beta, delta)


def lagrange_at(values: list[int], tau: int, log_n: int) -> int:
    """sum_j v_j L_j(tau) over the domain <w> (barycentric: L_j(tau) =
    Z(tau) w^j / (n (tau - w^j))), the v_j past len(values) being 0."""
    from crypto3_fil_proofs_torch.ops.bls12_381 import R
    from crypto3_fil_proofs_torch.ops.ntt import root_of_unity

    n = 1 << log_n
    w = root_of_unity(log_n)
    pows, cur = [], 1
    for _ in range(len(values)):
        pows.append(cur)
        cur = cur * w % R
    den = [(tau - p) % R for p in pows]
    prefix = [1]
    for d in den:
        prefix.append(prefix[-1] * d % R)
    inv = pow(prefix[-1], R - 2, R)
    acc = 0
    for j in range(len(den) - 1, -1, -1):
        acc = (acc + values[j] * pows[j] % R * (prefix[j] * inv % R)) % R
        inv = inv * den[j] % R
    z = (pow(tau, n, R) - 1) % R
    return acc * z % R * pow(n, R - 2, R) % R


def prove_witness(rng) -> list[int]:
    """The 2^19 prove's witness: half bits, half uniform in [0, r);
    variable 0 is 1."""
    witness = uniform_scalars(N_VARS, rng)
    bits = rng.integers(0, 2, N_VARS)
    is_bit = rng.random(N_VARS) < 0.5
    witness = [int(b) if ib else w for w, b, ib in zip(witness, bits, is_bit)]
    witness[0] = 1
    return witness


def phase_prove(seed: int) -> dict:
    """The Groth16 path at full width (see the module docstring)."""
    import hashlib
    import random as _random

    import numpy as np
    import torch

    from crypto3_fil_proofs_torch.core.measure import measurements
    from crypto3_fil_proofs_torch.ops import bls12_381 as B
    from crypto3_fil_proofs_torch.ops import field as F
    from crypto3_fil_proofs_torch.ops.bls12_381 import R
    from crypto3_fil_proofs_torch.ops.cuda import field as k1
    from crypto3_fil_proofs_torch.ops.cuda import ntt as k3
    from crypto3_fil_proofs_torch.zk import groth16

    from crypto3_fil_proofs_torch.models.post.fallback.compound import FallbackPoStCompound
    from crypto3_fil_proofs_torch.models.post.fallback.vanilla import PublicParams

    blank = FallbackPoStCompound((8, 8, 0)).blank_circuit(PublicParams(32 << 30, 66, 1))
    counts = (blank.num_constraints, len(blank.values), blank.num_inputs)
    del blank
    if counts != (N_CONSTRAINTS, N_VARS, N_INPUTS):
        raise AssertionError(f"the blank 32 GiB Winning PoSt circuit has {counts} constraints, variables and "
                             f"inputs, not {(N_CONSTRAINTS, N_VARS, N_INPUTS)}")
    t0 = time.time()
    pk, logs, (alpha, beta, delta) = synthetic_key(seed)
    rng = np.random.default_rng(seed + 31)
    witness = prove_witness(rng)
    inputs, aux = witness[:N_INPUTS], witness[N_INPUTS:]
    # the row evaluations: a, b random, c = a b (input rows included)
    rows = N_CONSTRAINTS + N_INPUTS
    a = uniform_scalars(rows, rng) + [0] * ((1 << LOG_N) - rows)
    b = uniform_scalars(rows, rng) + [0] * ((1 << LOG_N) - rows)
    c = [x * y % R for x, y in zip(a, b)]
    setup_s = time.time() - t0
    log(f"phase 11: synthetic key and witness at the sizes of the port's blank 32 GiB Winning PoSt circuit "
        f"({N_CONSTRAINTS} constraints, {N_VARS} variables, {N_INPUTS} inputs, domain 2^{LOG_N}) in "
        f"{setup_s:.1f} s")

    from crypto3_fil_proofs_torch.ops.cuda import g1 as k4
    from crypto3_fil_proofs_torch.ops.cuda import g2 as k5
    from crypto3_fil_proofs_torch.ops.cuda import msm as k6

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    # the main path: counts from 0 just before it, read just after it
    reset_counts()
    t0 = time.time()
    h = groth16.h_from_evals(a, b, c, LOG_N, device=DEVICE)
    t_h = time.time() - t0
    proof = groth16.prove_from_assignment(pk, inputs, aux, h, randomness=b"winning-post", device=DEVICE)
    torch.cuda.synchronize()
    total = time.time() - t0
    launches = all_counts()
    peak_all = torch.cuda.max_memory_allocated()
    spans = {k: v for k, v in measurements().items()
             if k in ("prove_to_device", "prove_assembly") or k.startswith("prove_msm_")}
    spans["h_from_evals"] = t_h

    # the standalone doubling runs only where two points of the scalar-1
    # sum meet themselves; the MSMs' doublings are inside their kernels
    path = ["fr_montmul", "fr_sub", "ntt"] + [
        f"{g}_{op}" for g in ("g1", "g2") for op in ("madd_nodbl", "add")
    ] + [f"msm_{g}_{op}" for g in ("g1", "g2") for op in ("bucket_acc", "bucket_reduce", "agg_level")]
    for name in path:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{name} was not launched on the prove path")

    # h: coefficient n - 1 is 0, and A(t) B(t) - C(t) = h(t) (t^n - 1)
    full = k3.h_from_evals(*(k1.to_mont(F.ints_to_limbs32(v).to(DEVICE)) for v in (a, b, c)), LOG_N)
    top = F.limbs32_to_ints(k1.from_mont(full[-1:]))[0]
    if top != 0:
        raise AssertionError("h's coefficient n - 1 is not 0")
    tau = int.from_bytes(hashlib.sha256(b"tau" + bytes([seed % 256])).digest(), "little") % R
    h_tau = 0
    for coeff in reversed(h):
        h_tau = (h_tau * tau + coeff) % R
    lhs = (lagrange_at(a[:rows], tau, LOG_N) * lagrange_at(b[:rows], tau, LOG_N)
           - lagrange_at(c[:rows], tau, LOG_N)) % R
    if lhs != h_tau * (pow(tau, 1 << LOG_N, R) - 1) % R:
        raise AssertionError("A(t) B(t) - C(t) != h(t) (t^n - 1) at a random t")

    # the proof in the exponent
    r_rng = _random.Random(hashlib.sha256(b"winning-post").digest())
    r, s = r_rng.randrange(R), r_rng.randrange(R)
    dot = lambda xs, ks: sum(x * k for x, k in zip(xs, ks)) % R
    ea = (alpha + dot(witness, logs["a_query"]) + r * delta) % R
    eb2 = (beta + dot(witness, logs["b_g2_query"]) + s * delta) % R
    eb1 = (beta + dot(witness, logs["b_g1_query"]) + s * delta) % R
    ec = (dot(aux, logs["l_query"]) + dot(h, logs["h_query"]) + s * ea + r * eb1 - r * s * delta) % R
    g1, g2 = B.g1_from_affine(B.G1_GEN), B.g2_from_affine((B.G2_GEN_X, B.G2_GEN_Y))
    want = (B.g1_to_compressed(B.g1_mul(g1, ea)) + B.g2_to_compressed(B.g2_mul(g2, eb2))
            + B.g1_to_compressed(B.g1_mul(g1, ec)))
    if proof.to_bytes() != want:
        raise AssertionError("the 2^19 proof != A, B, C computed on the host in the exponent")
    log(f"phase 11: proof of the 2^{LOG_N} circuit == the host's exponent computation; h passes "
        f"the identity at a random t and its coefficient n - 1 is 0")
    log(f"  prove wall {total:.3f} s; stages " + json.dumps({k: round(v, 4) for k, v in spans.items()}))
    log(f"  launches {json.dumps(launches)}")
    log(f"  max_memory_allocated {peak_all} B, of which the path {peak_all - held} B")
    trace = trace_prove(pk, inputs, aux, (a, b, c))
    return {"launches": launches, "spans": spans, "total_s": total, "peak_bytes": peak_all - held,
            "setup_s": setup_s, "trace": trace}


def torch_sync() -> None:
    import torch

    torch.cuda.synchronize()


def trace_device(fn) -> dict:
    """fn() once under torch.profiler: device time (us) by kernel name and
    in all, against the traced wall time. Not a phase check: a trace
    without device events reads "not measured"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    by_name = {}
    for e in prof.key_averages():
        # device events only: CPU ops would count their kernels twice, and
        # the spans' GPU annotations cover whole stages
        if (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and not getattr(e, "is_user_annotation", False)):
            by_name[e.key] = e.self_device_time_total
    copies_s = sum(v for k, v in by_name.items() if k.startswith(("Memcpy", "Memset"))) / 1e6
    device_s = sum(by_name.values()) / 1e6
    return {"wall_s": wall, "device_s": device_s or None, "copies_s": copies_s, "us": by_name}


def device_ms(fn, names: tuple, reps: int = 50) -> float | None:
    """Mean device time per call of fn()'s kernels named `names[k]...`,
    from one trace of `reps` calls; None where the trace has no device
    events."""
    fn()
    torch_sync()
    tr = trace_device(lambda: [fn() for _ in range(reps)])
    if not tr["device_s"]:
        return None
    return sum(us for k, us in tr["us"].items() if k.startswith(names)) / 1e3 / reps


def log_trace(what: str, tr: dict) -> None:
    if tr["device_s"]:
        top = dict(sorted(tr["us"].items(), key=lambda kv: -kv[1])[:16])
        log(f"  traced {what}: wall {tr['wall_s']:.3f} s, device busy {tr['device_s']:.4f} s "
            f"({100 * tr['device_s'] / tr['wall_s']:.1f} %), of which copies {tr['copies_s']:.4f} s; "
            "device us by name " + json.dumps(top))
    else:
        log(f"  traced {what}: wall {tr['wall_s']:.3f} s, device time not measured (no device events)")


def trace_prove(pk, inputs, aux, evals) -> dict:
    """The same prove once more under torch.profiler."""
    from crypto3_fil_proofs_torch.zk import groth16

    def prove():
        h = groth16.h_from_evals(*evals, LOG_N, device=DEVICE)
        groth16.prove_from_assignment(pk, inputs, aux, h, randomness=b"winning-post", device=DEVICE)

    tr = trace_device(prove)
    log_trace("prove", tr)
    return tr


# each kernels-line row's kernels, as the profiler names them
TRACE_NAMES = {
    "fr_montmul": ("void montmul_kernel<Fr>(",), "fq_montmul": ("void montmul_kernel<Fq>(",),
    "poseidon_a2": ("void poseidon_kernel<3>(",), "poseidon_a8": ("void poseidon_kernel<9>(",),
    "poseidon_a11": ("void poseidon_kernel<12>(",), "fr_sub": ("fr_sub_kernel(",),
    "poseidon_witness": ("void witness_kernel<", "void witness_group_kernel<"),
    "ntt": ("void ntt_pass_kernel<",), "ntt_rows": ("ntt_rows_kernel(",),
    **{f"g1_{op}": (f"void {op}_kernel<fq_t>(",) for op in ("madd_nodbl", "dbl", "add", "madd")},
    **{f"g2_{op}": (f"pair_{op}_kernel(",) for op in ("madd_nodbl", "dbl", "add")},
    **{f"msm_{g}": tuple(f"void {k}_kernel<{e}>(" for k in ("bucket_acc", "bucket_reduce", "agg_level"))
       for g, e in (("g1", "fq_t"), ("g2", "fq2_t"))},
}


def path_ms(name: str, tr: dict | None) -> float | None:
    """Device ms of a row's kernels in one traced path run."""
    if not tr or not tr["device_s"]:
        return None
    return sum(v for k, v in tr["us"].items() if k.startswith(TRACE_NAMES[name])) / 1e3


def count_dicts() -> list[dict]:
    from crypto3_fil_proofs_torch.ops.cuda import field as k1
    from crypto3_fil_proofs_torch.ops.cuda import g1 as k4
    from crypto3_fil_proofs_torch.ops.cuda import g2 as k5
    from crypto3_fil_proofs_torch.ops.cuda import msm as k6
    from crypto3_fil_proofs_torch.ops.cuda import ntt as k3
    from crypto3_fil_proofs_torch.ops.cuda import poseidon as k2

    return [k1.launches, k2.launches, k3.launches, k4.launches, k5.launches,
            k6.K6_G1.launches, k6.K6_G2.launches]


def reset_counts() -> None:
    for d in count_dicts():
        for k in d:
            d[k] = 0
    WITNESS_BATCHES.clear()


# (arity, batch size) of each K7 call on the card since the counts were
# last set to 0; record_witness_batches() fills it
WITNESS_BATCHES: list = []


def record_witness_batches() -> None:
    """Record the batch size of every K7 call on the card (the wrapper's
    launch count stays its own)."""
    from crypto3_fil_proofs_torch.ops.cuda import poseidon as k2

    witness = k2.witness

    def recorded(pre, arity):
        if pre.is_cuda and pre.shape[0]:
            WITNESS_BATCHES.append((arity, int(pre.shape[0])))
        return witness(pre, arity)

    k2.witness = recorded


def witness_batches() -> list:
    """[arity, batch size, calls] of the K7 calls since the counts were
    last set to 0."""
    return [[a, n, WITNESS_BATCHES.count((a, n))] for a, n in sorted(set(WITNESS_BATCHES))]


def all_counts() -> dict:
    out = {}
    for d in count_dicts():
        out.update({(f"poseidon_a{k}" if isinstance(k, int) else k): v for k, v in d.items()})
    return out


# ---------------------------------------------------------------------------
# Phases 13-15: seal commit of the 512 MiB sector (C1, setup, C2, verify)
# ---------------------------------------------------------------------------

# the kernels every Groth16 setup and prove launches
GROTH16_PATH = ["fr_montmul", "fq_montmul", "fr_sub", "ntt"] + [
    f"{g}_{op}" for g in ("g1", "g2") for op in ("madd_nodbl", "add")
] + [f"msm_{g}_{op}" for g in ("g1", "g2") for op in ("bucket_acc", "bucket_reduce", "agg_level")]
COMMIT_SEED = bytes([7] * 32)  # the interactive seed of C1 (tests/golden/torch_commit_2k.json's)
SAMPLE = 1024  # variables (and h powers) per query in phase 14's check, lanes per query in phase 20's


def phase_commit1(run_2k: dict, run_512: dict) -> dict:
    """C1 of the 2 KiB sector against the frozen JAX digest, and of the
    512 MiB sector of phase 5, whose vanilla proofs must verify."""
    from crypto3_fil_proofs_torch.api import seal as api_seal
    from crypto3_fil_proofs_torch.models.porep.stacked.vanilla.params import PublicInputs, Tau, proofs_digest
    from crypto3_fil_proofs_torch.models.porep.stacked.vanilla.proof import StackedDrg
    from crypto3_fil_proofs_torch.parameters import public_params
    from crypto3_fil_proofs_torch.types import PoRepConfig

    with open(os.path.join(REPO, "tests", "golden", "torch_commit_2k.json")) as f:
        golden = json.load(f)
    seed = bytes.fromhex(golden["seed"])
    config = PoRepConfig.for_sector_size(golden["sector_size"], bytes.fromhex(golden["porep_id"]))
    c1 = api_seal.seal_commit_phase1(config, run_2k["cache"], run_2k["sealed"], PROVER_ID, SECTOR_ID, TICKET,
                                     seed, run_2k["p2"], [])
    if proofs_digest(c1.vanilla_proofs) != golden["vanilla_digest"]:
        raise AssertionError("2 KiB C1 vanilla proofs != the JAX package's (digest)")
    log(f"phase 13: 2 KiB C1 vanilla proofs == the JAX package's (digest {golden['vanilla_digest'][:16]}..)")
    check_circuit_2k(config, c1, seed)

    config = PoRepConfig.for_sector_size(SECTOR_SIZE, POREP_ID)
    t0 = time.time()
    c1 = api_seal.seal_commit_phase1(config, run_512["cache"], run_512["sealed"], PROVER_ID, SECTOR_ID, TICKET,
                                     COMMIT_SEED, run_512["p2"], [])
    c1_s = time.time() - t0
    pub = PublicInputs(replica_id=c1.replica_id, seed=COMMIT_SEED,
                       tau=Tau(comm_d=c1.comm_d, comm_r=c1.comm_r), k=None)
    if not StackedDrg.verify_all_partitions(public_params(config), pub, c1.vanilla_proofs):
        raise AssertionError("512 MiB C1 vanilla proofs do not verify")
    parts = c1.vanilla_proofs
    log(f"phase 13: {SECTOR_SIZE} B C1 in {c1_s:.3f} s: {len(parts)} partition(s) of {len(parts[0])} "
        "challenges; verify_all_partitions accepts")
    return {"c1": c1, "c1_s": c1_s}


def check_circuit_2k(config, c1, seed: bytes) -> None:
    """Phase 13: the registered stacked circuit of the 2 KiB C1 (one
    partition of two challenges, as C2 synthesizes it) == the JAX
    package's, by the digests of tests/golden/torch_commit_2k_circuit.json
    (tests/torch_commit_circuit_ref.py)."""
    from crypto3_fil_proofs_torch.constants import SECTOR_SHAPES
    from crypto3_fil_proofs_torch.models.porep.stacked.circuit.compound import StackedCompound
    from crypto3_fil_proofs_torch.models.porep.stacked.vanilla.params import PublicInputs, Tau
    from crypto3_fil_proofs_torch.parameters import public_params

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_commit_circuit_ref as ref

    with open(ref.GOLDEN) as f:
        golden = json.load(f)
    if golden["seed"] != seed.hex() or golden["comm_r"] != c1.comm_r.hex():
        raise AssertionError("the 2 KiB circuit golden is of another C1")
    pp = public_params(config)
    pub = PublicInputs(replica_id=c1.replica_id, seed=seed, tau=Tau(comm_d=c1.comm_d, comm_r=c1.comm_r), k=None)
    compound = StackedCompound(shape=SECTOR_SHAPES[config.sector_size])
    reset_counts()
    t0 = time.time()
    cs = compound.circuit_from_vanilla(pp, pub, c1.vanilla_proofs[0], 0, device=DEVICE)
    replays = all_counts()["poseidon_witness"]
    got = ref.summary_digest(ref.circuit_summary(cs))
    wall = time.time() - t0
    if replays <= 0:
        raise AssertionError("the 2 KiB circuit's witness was not replayed on K7")
    public = ref.digest_ints(compound.generate_public_inputs(pp, pub, 0))
    if got != golden["circuit"] or public != golden["public_digest"]:
        raise AssertionError(f"the 2 KiB two-challenge circuit != the JAX package's: {got} against "
                             f"{golden['circuit']}; public inputs {public == golden['public_digest']}")
    log(f"phase 13: the 2 KiB registered circuit ({len(c1.vanilla_proofs[0])} challenges, {got['constraints']} "
        f"constraints, {got['segments']} segments) == the JAX package's (segments, assignment, inputs; "
        f"tests/golden/torch_commit_2k_circuit.json), synthesized ({replays} K7 replays) and digested in "
        f"{wall:.1f} s")


def _lagrange(j: int, tau: int, z: int, omega: int, m_inv: int) -> int:
    """L_j(tau) = Z(tau) w^j / (m (tau - w^j)) on the domain <w> of size m."""
    from crypto3_fil_proofs_torch.ops.bls12_381 import R

    wj = pow(omega, j, R)
    return z * wj % R * pow((tau - wj) % R, R - 2, R) % R * m_inv % R


def sampled_uvw(fin, variables: list[int], num_vars: int, tau: int, log_n: int) -> dict:
    """u_i(tau), v_i(tau), w_i(tau) of the given auxiliary variables,
    from the finalized rows where each occurs: an evaluation independent
    of the setup's (`_qap_tau_evals` walks every row)."""
    import numpy as np

    from crypto3_fil_proofs_torch.ops.bls12_381 import R
    from crypto3_fil_proofs_torch.ops.ntt import root_of_unity

    m = 1 << log_n
    omega, z, m_inv = root_of_unity(log_n), (pow(tau, m, R) - 1) % R, pow(m, R - 2, R)
    lag = lambda j: _lagrange(j, tau, z, omega, m_inv)
    out = {v: [0, 0, 0] for v in variables}
    sel = np.zeros(num_vars, dtype=bool)
    sel[variables] = True
    for kind, seg, base in fin.segments():
        if kind == "d":
            for j, row in enumerate(seg):
                for side, terms in enumerate(row):
                    for var, co in terms.items():
                        if var in out:
                            out[var][side] = (out[var][side] + co * lag(base + j)) % R
            continue
        for side, k in enumerate("abc"):
            indptr, cols = getattr(seg, f"{k}_indptr"), np.asarray(getattr(seg, f"{k}_cols"))
            hit = np.nonzero(sel[cols])[0]
            rows = np.searchsorted(indptr, hit, side="right") - 1
            for h, r in zip(hit.tolist(), rows.tolist()):
                co = seg.pool[int(getattr(seg, f"{k}_idx")[h])] if hasattr(seg, "pool") else int(
                    getattr(seg, f"{k}_coeffs")[h])
                var = int(cols[h])
                out[var][side] = (out[var][side] + co * lag(base + r)) % R
    return out


def check_setup_batches(pk, compound, pp, prefix: str, seed: int) -> dict:
    """Phase 14's check, after the commit path: 4 x SAMPLE G1 scalars of
    the real a, b_g1, l and h lists (computed here from the rows
    independently of the setup) and SAMPLE b_g2 scalars, with 0, 1 and
    r - 1: the kernel batch == the plain batch on the card == the key's
    rows; the K1 normalisation == the plain one."""
    import hashlib

    import torch

    from crypto3_fil_proofs_torch.ops import field as F
    from crypto3_fil_proofs_torch.ops import fixed_base as fb
    from crypto3_fil_proofs_torch.ops.bls12_381 import R
    from crypto3_fil_proofs_torch.ops.g1_torch import G1
    from crypto3_fil_proofs_torch.ops.g2_torch import G2

    t0 = time.time()
    rng = random.Random(hashlib.sha256(prefix.encode()).digest())  # setup's draws, in order
    tau, alpha, beta, _gamma, delta = (rng.randrange(1, R) for _ in range(5))
    n_in, n_aux, fin, _, _ = compound.adapter.blank_circuit(pp).finalize()
    pick = random.Random(seed)
    variables = sorted(pick.sample(range(n_in, n_in + n_aux), SAMPLE))
    uvw = sampled_uvw(fin, variables, n_in + n_aux, tau, pk.log_n)
    del fin
    delta_inv = pow(delta, R - 2, R)
    z = (pow(tau, 1 << pk.log_n, R) - 1) % R
    powers = sorted(pick.sample(range((1 << pk.log_n) - 1), SAMPLE))
    rows = {
        "a_query": (variables, [uvw[i][0] for i in variables]),
        "b_g1_query": (variables, [uvw[i][1] for i in variables]),
        "l_query": ([i - n_in for i in variables],
                    [(beta * uvw[i][0] + alpha * uvw[i][1] + uvw[i][2]) % R * delta_inv % R for i in variables]),
        "h_query": (powers, [z * delta_inv % R * pow(tau, k, R) % R for k in powers]),
        "b_g2_query": (variables, [uvw[i][1] for i in variables]),
    }
    edges = [0, 1, R - 1]
    out = {"scalars_s": time.time() - t0}
    for curve, queries in ((G1, ("a_query", "b_g1_query", "l_query", "h_query")), (G2, ("b_g2_query",))):
        scalars = [s for q in queries for s in rows[q][1]] + edges
        sc = F.ints_to_limbs32(scalars).to(DEVICE)
        got = fb.fixed_base(curve, sc)
        want, plain_ms = timed(lambda: fb.fixed_base(curve, sc, plain=True))
        err = check_equal(f"{curve.name} fixed-base batch", got[0], want[0])
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"{curve.name} fixed-base valid flags != plain")
        lo = 0
        for q in queries:
            idx = torch.tensor(rows[q][0], device=DEVICE)
            pts, valid = getattr(pk, q)
            hi = lo + len(rows[q][0])
            if not (torch.equal(pts[idx], want[0][lo:hi]) and torch.equal(valid[idx], want[1][lo:hi])):
                raise AssertionError(f"{q}: the key's rows != the plain fixed-base of their scalars")
            lo = hi
        acc = fb._run_chunk(curve, fb.window_table(curve, DEVICE), sc, plain=False)
        norm, plain_norm = fb.normalize(curve, acc), curve.normalize(acc)
        err_n = check_equal(f"{curve.name} normalisation", norm[0], plain_norm[0])
        if not torch.equal(norm[1], plain_norm[1]):
            raise AssertionError(f"{curve.name} normalisation valid flags != plain")
        out[curve.name] = {"lanes": len(scalars), "max_abs_err": err, "norm_max_abs_err": err_n,
                           "ms": cuda_ms(lambda: fb.fixed_base(curve, sc), 3),
                           "plain_ms": plain_ms}
    log(f"phase 14: fixed-base batches == plain on the card == the key's rows: G1 {out['g1']['lanes']} "
        f"scalars of a, b_g1, l, h; G2 {out['g2']['lanes']} of b_g2 (0, 1, r - 1 included; "
        f"u, v, w of {SAMPLE} variables recomputed from the rows); K1 normalisation == plain; "
        f"{time.time() - t0:.1f} s")
    return out


def merge_traces(*traces: dict) -> dict:
    """One trace of runs traced one after another."""
    us: dict = {}
    for tr in traces:
        for k, v in tr["us"].items():
            us[k] = us.get(k, 0) + v
    device = [tr["device_s"] for tr in traces]
    return {"wall_s": sum(tr["wall_s"] for tr in traces),
            "device_s": None if None in device else sum(device),
            "copies_s": sum(tr["copies_s"] for tr in traces), "us": us}


def log_disk(what: str, work: str) -> None:
    disk = shutil.disk_usage(work)
    log(f"  df {what}: {disk.free} B free of {disk.total} B")


def phase_commit(work: str, c1_run: dict, seed: int) -> dict:
    """Phases 14, 20 and 15: the commit path of the 512 MiB sector. Each
    of its two device runs is traced with the counts set to 0 just before
    it and read just after it: `paramcache`'s cache_porep_params (the
    setup of the blank circuit on cuda, into the run's parameter cache),
    then, after phase 14's batch check and the phase-2 ceremony on that
    key (phase 20, its own path), seal_commit_phase2 on cuda under the
    contributed key (which checks its proof with verify_seal). Then the
    proof's checks: verify_seal accepts it with the contributed vk and
    rejects it with the original one, a flipped bit and a wrong seed."""
    import torch

    from crypto3_fil_proofs_torch import caches
    from crypto3_fil_proofs_torch.api import seal as api_seal
    from crypto3_fil_proofs_torch.cli import paramcache
    from crypto3_fil_proofs_torch.core.measure import measurements
    from crypto3_fil_proofs_torch.core.parameter_cache import meta_path, params_path
    from crypto3_fil_proofs_torch.parameters import public_params
    from crypto3_fil_proofs_torch.types import PoRepConfig

    os.environ["FIL_PROOFS_PARAMETER_CACHE"] = os.path.join(work, "params")
    config = PoRepConfig.for_sector_size(SECTOR_SIZE, POREP_ID)
    pp = public_params(config)
    compound = api_seal._stacked_compound(config)
    prefix = compound.adapter.cache_prefix(pp)
    c1 = c1_run["c1"]
    caches.clear_caches()
    torch_sync()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    state = {}

    def setup_path():
        t0 = time.time()
        state["pk"] = paramcache.cache_porep_params(SECTOR_SIZE, POREP_ID, device=DEVICE)
        torch_sync()
        state["setup_s"] = time.time() - t0

    def c2_path():
        t0 = time.time()
        state["c2"] = api_seal.seal_commit_phase2(config, c1, PROVER_ID, SECTOR_ID, device=DEVICE)
        torch_sync()
        state["c2_s"] = time.time() - t0

    # the main path, first run: counts from 0 just before it, read just after it
    reset_counts()
    setup_trace = trace_device(setup_path)
    launches = all_counts()
    peak = torch.cuda.max_memory_allocated() - held
    pk = state.pop("pk")
    spans = measurements()
    with open(meta_path(prefix)) as f:
        meta = json.load(f)
    setup_stages = {k: spans[k] for k in ("setup_blank_circuit", "setup_finalize", "setup_qap", "setup_scalars",
                                          "setup_fixed_base_g1", "setup_fixed_base_g2", "setup_save")}
    log(f"phase 14: paramcache cache_porep_params of the {SECTOR_SIZE} B circuit on cuda in {state['setup_s']:.1f} s: "
        f"{meta['num_constraints']} constraints, {meta['num_inputs']} inputs, domain 2^{pk.log_n}; "
        f"key {pk.nbytes()} B on the card, {os.path.getsize(params_path(prefix))} B on disk")
    log("  setup stages s " + json.dumps({k: round(v, 3) for k, v in setup_stages.items()}))
    batches = check_setup_batches(pk, compound, pp, prefix, seed)
    sharded_msm = phase_sharded_msm(pk, seed)

    ceremony = phase_ceremony(work, pk, prefix, seed)
    orig_vk = pk.vk
    del pk
    caches.clear_caches()
    torch.cuda.empty_cache()

    # the main path, second run: C2 under the contributed key, counts from 0
    torch_sync()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    c2_trace = trace_device(c2_path)
    c2_launches = all_counts()
    c2_batches = witness_batches()
    for k, v in c2_launches.items():
        launches[k] = launches.get(k, 0) + v
    peak = max(peak, torch.cuda.max_memory_allocated() - held)
    traced = merge_traces(setup_trace, c2_trace)
    proof = state["c2"].proof
    spans = measurements()

    # the proof: 192 bytes, accepted by verify_seal with the contributed
    # vk; the original vk, a flipped bit and a wrong seed are refused
    args = dict(comm_r=c1.comm_r, comm_d=c1.comm_d, prover_id=PROVER_ID, sector_id=SECTOR_ID,
                ticket=TICKET, seed=COMMIT_SEED, proof_bytes=proof)
    t0 = time.time()
    ok = api_seal.verify_seal(config, **args)
    verify_s = time.time() - t0
    flipped = bytearray(proof)
    flipped[7] ^= 1
    bad_bit = api_seal.verify_seal(config, **{**args, "proof_bytes": bytes(flipped)})
    bad_seed = api_seal.verify_seal(config, **{**args, "seed": bytes([8] * 32)})
    caches.clear_caches()
    caches._VK_CACHE[caches._key("STACKED-VK", SECTOR_SIZE)] = orig_vk
    bad_vk = api_seal.verify_seal(config, **args)
    caches.clear_caches()
    if len(proof) != 192 * config.partitions or not ok or bad_bit or bad_seed or bad_vk:
        raise AssertionError(f"verify_seal: proof {len(proof)} B accepted {ok}, flipped bit {bad_bit}, "
                             f"wrong seed {bad_seed}, the original vk {bad_vk}")
    c2_stages = {k: spans[k] for k in ("commit_synthesis", "commit_check", "prove_finalize", "prove_evals",
                                       "prove_h", "prove_to_device", "prove_msm_a", "prove_msm_b_g1",
                                       "prove_msm_b_g2", "prove_msm_h", "prove_msm_l", "prove_assembly")}
    c2_stages["verify_seal"] = verify_s
    log(f"phase 15: seal_commit_phase2 on cuda under the contributed key in {state['c2_s']:.1f} s (its load from "
        f"the cache included): {len(proof)}-byte proof, verify_seal accepts it with the contributed vk and rejects "
        "it with the original vk, a flipped bit and a wrong seed")
    log("  C2 stages s " + json.dumps({k: round(v, 3) for k, v in c2_stages.items()}))
    log(f"  launches on the commit path (setup and C2) {json.dumps({k: v for k, v in launches.items() if v})}; "
        f"max_memory_allocated of the path {peak} B")
    log(f"  K7's batches in C2 [arity, instances, calls] {json.dumps(c2_batches)}")
    log_trace("commit path (setup and C2)", traced)
    for name in GROTH16_PATH:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{name} was not launched on the commit path")
    require("C2", c2_launches, ["poseidon_witness"])
    del state
    caches.clear_caches()
    torch.cuda.empty_cache()
    return {"launches": launches, "trace": traced, "peak_bytes": peak, "setup_s": setup_stages,
            "c2_s": c2_stages, "batches": batches, "ceremony": ceremony, "sharded_msm": sharded_msm,
            "witness_batches": c2_batches}


# ---------------------------------------------------------------------------
# Phases 20-22: the parameter lifecycle (phase-2 ceremony, paramcache,
# the parameter files and their CLIs)
# ---------------------------------------------------------------------------

CEREMONY_SEED = "chip-smoke"  # phase2 contribute --seed


def staged_query(path: str, name: str):
    """(affine int32 [N, 2, 12], valid [N]) of one G1 query of a key
    file, read alone (the parameter cache's npz layout)."""
    import numpy as np
    import torch

    from crypto3_fil_proofs_torch.ops import field as F

    with np.load(path) as d:
        pts = torch.stack([F.from_jax_limbs(d[f"{name}_x"]), F.from_jax_limbs(d[f"{name}_y"])], dim=1)
        return pts, torch.from_numpy(d[f"{name}_valid"].astype(bool))


def phase_ceremony(work: str, pk, prefix: str, seed: int) -> dict:
    """Phase 20: the phase-2 ceremony on the 512 MiB key that phase 14
    cached. `phase2 contribute --seed` rescales l_query and h_query on the
    card (ops/g1_scale.py: K4 dbl and g1_madd, K1 fq), its own path with
    the counts from 0 just before it; SAMPLE lanes of each rescaled query
    (and its first and last) == the plain version on the card == host
    g1_mul by d^-1; `verify old new` passes and a copy whose delta_g2 is
    left unscaled fails; `small --out`, `merge --original` and
    `split-keys --prefix` put the contributed key in the cache in place of
    the original; the intermediate file is deleted."""
    import torch

    from crypto3_fil_proofs_torch.cli import phase2
    from crypto3_fil_proofs_torch.core.parameter_cache import params_path
    from crypto3_fil_proofs_torch.ops.bls12_381 import R, g1_eq, g1_mul
    from crypto3_fil_proofs_torch.ops.fixed_base import host_points
    from crypto3_fil_proofs_torch.ops.g1_scale import scale_g1
    from crypto3_fil_proofs_torch.ops.g1_torch import G1

    orig = params_path(prefix)
    cdir = os.path.join(work, "ceremony")
    os.makedirs(cdir)
    new = os.path.join(cdir, "stacked_512MiB_1")
    lanes = pk.l_query[1].shape[0] + pk.h_query[1].shape[0]
    d_inv = pow(phase2.contribution_scalar(CEREMONY_SEED), R - 2, R)
    log_disk("before phase 20", work)
    steps = {}

    def run(name: str, *argv) -> None:
        t0 = time.time()
        rc = phase2.main(list(argv))
        steps[name] = time.time() - t0
        if rc != 0:
            raise AssertionError(f"phase2 {name}: exit code {rc}")

    # the phase-2 path: counts from 0 just before it, read just after it
    reset_counts()
    traced = trace_device(lambda: run("contribute", "contribute", orig, "--seed", CEREMONY_SEED, "--out", new,
                                      "--device", DEVICE))
    launches = all_counts()
    log_disk("after contribute", work)

    t0 = time.time()
    pick = random.Random(seed)
    sample = {}
    for q in ("l_query", "h_query"):
        pts, valid = getattr(pk, q)
        n = valid.shape[0]
        idx = torch.tensor(sorted({0, n - 1, *pick.sample(range(n), SAMPLE)}))
        new_pts, new_valid = staged_query(new, q)
        on = idx.to(pts.device)
        sample[q] = (pts[on], valid[on], new_pts[idx], new_valid[idx])
        del new_pts, new_valid
    o_pts = torch.cat([v[0] for v in sample.values()])
    o_valid = torch.cat([v[1] for v in sample.values()])
    g_pts = torch.cat([v[2] for v in sample.values()]).to(DEVICE)
    g_valid = torch.cat([v[3] for v in sample.values()]).to(DEVICE)
    want = scale_g1(o_pts[:, 0], o_pts[:, 1], o_valid, d_inv, device=DEVICE, plain=True)
    check_equal("phase-2 rescaled sample against the plain version", g_pts, want[0])
    if not torch.equal(g_valid, want[1]):
        raise AssertionError("phase-2 rescaled sample: valid flags != the plain version's")
    for p, q in zip(host_points(G1, o_pts, o_valid), host_points(G1, g_pts, g_valid)):
        if not g1_eq(q, g1_mul(p, d_inv)):
            raise AssertionError("phase-2 rescaled sample != host g1_mul by d^-1")
    steps["sample_check"] = time.time() - t0
    log(f"phase 20: phase2 contribute of the {SECTOR_SIZE} B key on {DEVICE} in {steps['contribute']:.1f} s: "
        f"{lanes} lanes of l_query and h_query rescaled by d^-1; {sample['l_query'][0].shape[0]} of l_query and "
        f"{sample['h_query'][0].shape[0]} of h_query == the plain version on the card == host g1_mul")

    run("verify", "verify", orig, new)
    head = phase2.load_key_head(new)
    if phase2.verify_contribution(pk, phase2.KeyHead(pk.vk, head.delta_g1, head.h_query)) == 0:
        raise AssertionError("phase2 verify accepts a contribution whose delta_g2 is left unscaled")
    del sample
    small = os.path.join(cdir, "small.json")
    run("small", "small", new, "--out", small)
    run("merge", "merge", small, new, "--original", orig)
    run("split_keys", "split-keys", new, "--prefix", prefix)
    os.remove(new)
    os.remove(new + ".meta")
    log_disk("after split-keys and the intermediate file's deletion", work)
    log(f"phase 20: verify accepts the contribution and refuses a copy whose delta_g2 is unscaled; small, merge "
        f"--original and split-keys put it in the cache; steps s {json.dumps({k: round(v, 3) for k, v in steps.items()})}")
    log(f"  launches on the phase-2 path {json.dumps({k: v for k, v in launches.items() if v})}")
    log_trace("phase2 contribute", traced)
    for name in ("g1_dbl", "g1_madd", "fq_montmul"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{name} was not launched on the phase-2 path")
    return {"launches": launches, "trace": traced, "steps": steps, "lanes": lanes,
            "dbl_steps": d_inv.bit_length() - 1, "madd_steps": bin(d_inv).count("1") - 1}


def key_digest(path: str) -> str:
    """tests/test_torch_setup.py `arrays_digest` of a key file."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    with np.load(path) as d:
        for k in sorted(d.files):
            a = np.ascontiguousarray(d[k])
            h.update(f"{k}:{a.dtype.str}:{a.shape}:".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def phase_paramcache_2k(work: str, run_2k: dict) -> dict:
    """Phase 21: `paramcache --only-post` for 2 KiB on cuda into a fresh
    cache: the registered Window key (10 x 2) == the frozen JAX key
    (tests/golden/torch_post.json) and its blank circuit's counts == the
    golden's; then the registered Winning key (66 x 1): `phase2
    contribute` on cuda, `verify`, `split-keys` into a second fresh cache,
    a Winning PoSt of phase 4's sector proved from that cache on cuda,
    which verify_winning_post accepts with the contributed vk and refuses
    with the original."""
    from crypto3_fil_proofs_torch import caches
    from crypto3_fil_proofs_torch.api import post as api_post
    from crypto3_fil_proofs_torch.cli import paramcache, phase2
    from crypto3_fil_proofs_torch.core.parameter_cache import meta_path, params_path
    from crypto3_fil_proofs_torch.types import PoStConfig, PrivateReplicaInfo, PublicReplicaInfo

    with open(os.path.join(REPO, "tests", "golden", "torch_post.json")) as f:
        golden = json.load(f)
    size = golden["sector_size"]
    first, second = os.path.join(work, "params_paramcache"), os.path.join(work, "params_contributed")
    os.environ["FIL_PROOFS_PARAMETER_CACHE"] = first
    caches.clear_caches()
    t0 = time.time()
    if paramcache.main(["--params-for-sector-sizes", str(size), "--only-post", "--device", DEVICE]) != 0:
        raise AssertionError("paramcache --only-post failed")
    wall = time.time() - t0
    window, winning = PoStConfig.window(size), PoStConfig.winning(size)
    w = golden["window"]
    counts = next(c for c in golden["blank_counts"] if (c["sector_size"], c["challenge_count"], c["sector_count"])
                  == (size, window.challenge_count, window.sector_count))
    with open(meta_path(post_prefix(window))) as f:
        meta = json.load(f)
    if post_prefix(window) != w["cache_prefix"] or key_digest(params_path(w["cache_prefix"])) != w["key_digest"]:
        raise AssertionError("paramcache's 2 KiB Window key != the JAX package's")
    if (meta["num_constraints"], meta["num_inputs"]) != (counts["constraints"], counts["inputs"]):
        raise AssertionError(f"2 KiB Window blank circuit {meta} != the golden's counts {counts}")
    prefix = post_prefix(winning)
    with open(meta_path(prefix)) as f:
        win_meta = json.load(f)
    log(f"phase 21: paramcache --only-post {size} on {DEVICE} in {wall:.1f} s: the Window key (10 x 2, "
        f"{meta['num_constraints']} constraints) == the JAX package's; the Winning key (66 x 1, "
        f"{win_meta['num_constraints']} constraints, {win_meta['num_inputs']} inputs) made")

    contributed = os.path.join(work, "winning_2048_1")
    t0 = time.time()
    for argv in (["contribute", params_path(prefix), "--seed", CEREMONY_SEED, "--out", contributed,
                  "--device", DEVICE], ["verify", params_path(prefix), contributed]):
        if phase2.main(argv) != 0:
            raise AssertionError(f"phase2 {argv[0]} of the 2 KiB Winning key failed")
    os.environ["FIL_PROOFS_PARAMETER_CACHE"] = second
    if phase2.main(["split-keys", contributed, "--prefix", prefix]) != 0:
        raise AssertionError("phase2 split-keys of the 2 KiB Winning key failed")
    ceremony_s = time.time() - t0
    caches.clear_caches()
    comm_r = run_2k["p2"].comm_r
    replicas = {SECTOR_ID: PrivateReplicaInfo(replica_path=run_2k["sealed"], comm_r=comm_r,
                                              cache_dir=run_2k["cache"])}
    public = {SECTOR_ID: PublicReplicaInfo(comm_r=comm_r)}
    rnd = bytes.fromhex(golden["randomness"])
    t0 = time.time()
    proof = api_post.generate_winning_post(winning, rnd, replicas, PROVER_ID, device=DEVICE)
    prove_s = time.time() - t0
    ok = api_post.verify_winning_post(winning, rnd, public, PROVER_ID, proof)
    os.environ["FIL_PROOFS_PARAMETER_CACHE"] = first
    caches.clear_caches()
    with_original = api_post.verify_winning_post(winning, rnd, public, PROVER_ID, proof)
    caches.clear_caches()
    if not ok or with_original:
        raise AssertionError(f"2 KiB Winning PoSt under the contributed key: accepted with the contributed vk {ok}, "
                             f"with the original {with_original}")
    log(f"phase 21: phase2 contribute, verify and split-keys of the 2 KiB Winning key in {ceremony_s:.1f} s; its "
        f"Winning PoSt proved from the second cache on {DEVICE} in {prove_s:.1f} s verifies with the contributed "
        "vk and not with the original")
    return {"wall_s": wall, "ceremony_s": ceremony_s, "prove_s": prove_s, "cache": first}


IPFS_STAND_IN = """#!/bin/sh
PYTHONPATH={repo} exec {python} -m crypto3_fil_proofs_torch.cli.fakeipfsadd "$@"
"""
# `ipget -o <target> <cid>`: the copy fakeipfsadd kept whose content has that CID
IPGET_STAND_IN = """#!{python}
import glob, os, shutil, sys
sys.path.insert(0, {repo!r})
from crypto3_fil_proofs_torch.cli.fakeipfsadd import fake_cid
out, cid = sys.argv[2], sys.argv[3]
for p in glob.glob(os.path.join(os.environ["TMPDIR"], "fakeipfs-*", "*")):
    if fake_cid(p) == cid:
        shutil.copy(p, out)
        sys.exit(0)
sys.exit(1)
"""


def phase_param_files(work: str, cache: str) -> None:
    """Phase 22: param.py's digests of the files phase 21's paramcache
    wrote; `parampublish` with fakeipfsadd as the `ipfs` binary writes a
    parameters.json; `paramfetch` of that manifest (a content-addressed
    stand-in for `ipget`) fills an empty cache with equal digests,
    replaces a corrupted cached file and refuses a file whose digest
    disagrees with the manifest."""
    from crypto3_fil_proofs_torch import param
    from crypto3_fil_proofs_torch.cli import paramfetch, parampublish

    store, fetched = os.path.join(work, "ipfs_store"), os.path.join(work, "params_fetched")
    os.makedirs(store)
    os.makedirs(fetched)
    ipfs, ipget = os.path.join(work, "ipfs"), os.path.join(work, "ipget")
    for path, text in ((ipfs, IPFS_STAND_IN), (ipget, IPGET_STAND_IN)):
        with open(path, "w") as f:
            f.write(text.format(repo=REPO, python=sys.executable))
        os.chmod(path, 0o755)
    saved_tmp = os.environ.get("TMPDIR")
    os.environ["TMPDIR"] = store
    os.environ["FIL_PROOFS_PARAMETER_CACHE"] = cache
    try:
        t0 = time.time()
        files = param.cached_parameter_files()
        digests = {f: param.get_digest_for_file_within_cache(f) for f in files}
        manifest = os.path.join(work, "parameters.json")
        if parampublish.main(["--json", manifest, "--ipfs-bin", ipfs]) != 0:
            raise AssertionError("parampublish failed")
        published = param.read_parameter_map(manifest)
        if not published or any(published[f].digest != digests[f] for f in published):
            raise AssertionError("parameters.json digests != param.py's")
        os.environ["FIL_PROOFS_PARAMETER_CACHE"] = fetched
        fetch = ["--json", manifest, "--all", "--ipget-bin", ipget, "--retry", "1"]
        if paramfetch.main(fetch) != 0:
            raise AssertionError("paramfetch into an empty cache failed")
        if {f: param.get_digest_for_file_within_cache(f) for f in published} != {f: digests[f] for f in published}:
            raise AssertionError("fetched files' digests != the published files'")
        victim = sorted(published)[0]
        with open(os.path.join(fetched, victim), "r+b") as f:
            f.write(b"corrupted")
        if paramfetch.main(fetch) != 0 or param.get_digest_for_file_within_cache(victim) != digests[victim]:
            raise AssertionError("paramfetch kept a corrupted cached file")
        published[victim].digest = "0" * 32
        param.write_parameter_map(manifest, published)
        os.remove(os.path.join(fetched, victim))
        if paramfetch.main(fetch) != 1 or os.path.exists(os.path.join(fetched, victim)):
            raise AssertionError("paramfetch accepted a file whose digest disagrees with the manifest")
    finally:
        if saved_tmp is None:
            os.environ.pop("TMPDIR", None)
        else:
            os.environ["TMPDIR"] = saved_tmp
    log(f"phase 22: param.py digests of {len(files)} cached files; parampublish (fakeipfsadd) of "
        f"{len(published)} and paramfetch into an empty cache: digests equal; a corrupted cached file refetched, a "
        f"file whose digest disagrees with the manifest refused; {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phases 16-19: unseal and fallback PoSt of the 512 MiB sector, 2 KiB PoSt
# ---------------------------------------------------------------------------

UNSEAL_RANGE = (12_345_677, 3_000_001)  # an odd offset and length, cutting elements
POST_RANDOMNESS = bytes([44] * 31 + [0])  # tests/golden/torch_post.json's
POST_STAGES = ("post_vanilla", "setup_blank_circuit", "setup_finalize", "setup_qap", "setup_scalars",
               "setup_fixed_base_g1", "setup_fixed_base_g2", "setup_save", "commit_synthesis", "commit_check",
               "prove_finalize", "prove_evals", "prove_h", "prove_to_device", "prove_msm_a", "prove_msm_b_g1",
               "prove_msm_b_g2", "prove_msm_h", "prove_msm_l", "prove_assembly")


def staged_piece(seed: int):
    """The 512 MiB sector's piece, as phase 5 makes it."""
    import numpy as np

    from crypto3_fil_proofs_torch.core.fr32 import to_unpadded_bytes

    return np.random.default_rng(seed).integers(0, 256, to_unpadded_bytes(SECTOR_SIZE), dtype=np.uint8)


def phase_unseal(work: str, run: dict, seed: int) -> dict:
    """Phase 16: the whole replica unsealed to a file equals the staged
    piece, then unseal_range at an odd offset and length equals its
    slice. Host work (the labeler regenerates the key layer, a numpy
    decode and unpad), run in a thread beside phases 6-15: the labeler
    and numpy run outside the interpreter's lock, and each unseal takes
    a minute or more."""
    import numpy as np

    from crypto3_fil_proofs_torch.api import mod as api_mod
    from crypto3_fil_proofs_torch.core.measure import measurements
    from crypto3_fil_proofs_torch.types import PoRepConfig

    config = PoRepConfig.for_sector_size(SECTOR_SIZE, POREP_ID)
    args = (PROVER_ID, SECTOR_ID, run["p2"].comm_d, TICKET)
    out = os.path.join(work, "unsealed")
    piece = staged_piece(seed)
    t0 = time.time()
    n = api_mod.get_unsealed_range(config, run["cache"], run["sealed"], out, *args, 0, piece.shape[0])
    wall = time.time() - t0
    # this thread alone records the unseal spans
    spans = {k: measurements()[k] for k in ("unseal_key", "unseal_decode", "unseal_unpad")}
    if n != piece.shape[0] or not np.array_equal(np.fromfile(out, dtype=np.uint8), piece):
        raise AssertionError("the unsealed 512 MiB sector != the staged piece")
    os.remove(out)
    log(f"phase 16: get_unsealed_range of the {SECTOR_SIZE} B replica == the staged piece ({n} B) in {wall:.1f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in spans.items())}; beside phases 6-15)")
    off, length = UNSEAL_RANGE
    t0 = time.time()
    part = api_mod.unseal_range(config, run["cache"], run["sealed"], *args, off, length)
    range_wall = time.time() - t0
    if part != piece[off : off + length].tobytes():
        raise AssertionError(f"unseal_range({off}, {length}) != the staged piece's slice")
    log(f"phase 16: unseal_range{UNSEAL_RANGE} == the staged piece's slice in {range_wall:.1f} s")
    return {"wall_s": wall, "spans": spans, "range_wall_s": range_wall}


class CallTimer:
    """Total wall time of every call of module.name while active (the
    Poseidon witness replay is called once per PoR level), and each
    call's arguments."""

    def __init__(self, module, name: str):
        self.module, self.name, self.total, self.calls, self.args = module, name, 0.0, 0, []

    def __enter__(self):
        fn = getattr(self.module, self.name)

        def timed_fn(*a, **kw):
            self.args.append((a, kw))
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.total += time.perf_counter() - t0
                self.calls += 1

        self.orig = fn
        setattr(self.module, self.name, timed_fn)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def post_config(kind: str, size: int):
    from crypto3_fil_proofs_torch.types import PoStConfig, PoStType

    if kind == "winning_2KiB":
        return PoStConfig(sector_size=size, challenge_count=2, sector_count=1, typ=PoStType.WINNING)
    return PoStConfig.winning(size) if kind.startswith("winning") else PoStConfig.window(size)


def post_prefix(config) -> str:
    from crypto3_fil_proofs_torch.api import post as api_post
    from crypto3_fil_proofs_torch.parameters import window_post_public_params, winning_post_public_params

    params = (winning_post_public_params if config.typ.value == "winning" else window_post_public_params)(config)
    return api_post._compound(config).adapter.cache_prefix(params)


def phase_post(work: str, run: dict, kind: str, phase: int) -> dict:
    """Phases 17 and 18: Winning / Window PoSt of the 512 MiB sector on
    cuda, traced, the counts from 0 just before: the parameter cache's
    setup (a private cache, so it runs) and the proof; then
    verification, and the tampered forms' rejection."""
    import torch

    from crypto3_fil_proofs_torch import caches
    from crypto3_fil_proofs_torch.api import post as api_post
    from crypto3_fil_proofs_torch.core.measure import measurements
    from crypto3_fil_proofs_torch.core.parameter_cache import meta_path, params_path
    from crypto3_fil_proofs_torch.types import PrivateReplicaInfo, PublicReplicaInfo
    from crypto3_fil_proofs_torch.zk.gadgets import tiled

    os.environ["FIL_PROOFS_PARAMETER_CACHE"] = os.path.join(work, f"params_{kind}")
    caches.clear_caches()
    config = post_config(kind, SECTOR_SIZE)
    comm_r = run["p2"].comm_r
    replicas = {SECTOR_ID: PrivateReplicaInfo(replica_path=run["sealed"], comm_r=comm_r, cache_dir=run["cache"])}
    generate = api_post.generate_winning_post if config.typ.value == "winning" else api_post.generate_window_post
    verify = api_post.verify_winning_post if config.typ.value == "winning" else api_post.verify_window_post
    torch_sync()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    state = {}

    def post_path():
        t0 = time.time()
        state["proof"] = generate(config, POST_RANDOMNESS, replicas, PROVER_ID, device=DEVICE)
        torch_sync()
        state["wall_s"] = time.time() - t0

    # the main path: counts from 0 just before it, read just after it
    reset_counts()
    with CallTimer(tiled, "poseidon_witness_v") as witness:
        traced = trace_device(post_path)
    launches = all_counts()
    batches = witness_batches()
    peak = torch.cuda.max_memory_allocated() - held
    spans = measurements()
    stages = {k: spans[k] for k in POST_STAGES}
    stages["poseidon_witness_v"] = witness.total
    proof = state["proof"]
    pub = {SECTOR_ID: PublicReplicaInfo(comm_r=comm_r)}
    t0 = time.time()
    ok = verify(config, POST_RANDOMNESS, pub, PROVER_ID, proof)
    stages["verify"] = time.time() - t0
    flipped = bytearray(proof)
    flipped[7] ^= 1
    bad_bit = verify(config, POST_RANDOMNESS, pub, PROVER_ID, bytes(flipped))
    bad_rnd = verify(config, bytes(32), pub, PROVER_ID, proof)
    if len(proof) != 192 or not ok or bad_bit or bad_rnd:
        raise AssertionError(f"{kind} PoSt: proof {len(proof)} B accepted {ok}, flipped bit {bad_bit}, "
                             f"wrong randomness {bad_rnd}")
    prefix = post_prefix(config)
    with open(meta_path(prefix)) as f:
        meta = json.load(f)
    log(f"phase {phase}: {kind} PoSt ({config.challenge_count} challenges x {config.sector_count} sectors, the "
        f"sector {'duplicated' if config.sector_count > 1 else 'once'}) on {DEVICE} in {state['wall_s']:.1f} s with "
        f"the setup of its key: {meta['num_constraints']} constraints, {meta['num_inputs']} inputs; key "
        f"{os.path.getsize(params_path(prefix))} B on disk; the 192-byte proof verifies, a flipped bit and a "
        "wrong randomness do not")
    log("  stages s " + json.dumps({k: round(v, 3) for k, v in stages.items()})
        + f" (poseidon_witness_v: {witness.calls} calls; K7's batches [arity, instances, calls] "
        f"{json.dumps(batches)})")
    log(f"  launches {json.dumps({k: v for k, v in launches.items() if v})}; max_memory_allocated of the path "
        f"{peak} B")
    log_trace(f"{kind} PoSt (setup and prove)", traced)
    require(f"{kind} PoSt", launches, GROTH16_PATH + ["poseidon_witness"])
    caches.clear_caches()
    torch.cuda.empty_cache()
    return {"launches": launches, "trace": traced, "peak_bytes": peak, "stages": stages,
            "constraints": meta["num_constraints"], "wall_s": state["wall_s"], "witness_batches": batches}


def phase_sector_challenges() -> None:
    """Phase 17: generate_winning_post_sector_challenge == the frozen JAX values."""
    from crypto3_fil_proofs_torch.api import post as api_post

    with open(os.path.join(REPO, "tests", "golden", "torch_post.json")) as f:
        golden = json.load(f)
    g = golden["sector_challenges"]
    config = post_config("winning", SECTOR_SIZE)
    pid, rnd = bytes.fromhex(g["prover_id"]), bytes.fromhex(golden["randomness"])
    for n, want in g["winning_512MiB"].items():
        if api_post.generate_winning_post_sector_challenge(config, rnd, int(n), pid) != want:
            raise AssertionError(f"winning sector challenge over {n} sectors != the JAX package's")
    log(f"phase 17: generate_winning_post_sector_challenge == the JAX package's over {len(g['winning_512MiB'])} "
        "sector-set sizes")


def phase_level_cache(work: str, run: dict) -> dict:
    """Phase 17: a compacted copy of tree_r_last reopened over the replica
    as a LevelCache tree on cuda; its inclusion proofs of the Winning
    challenges == the full store's, each rebuilding its segment on K2."""
    from crypto3_fil_proofs_torch.api import post as api_post
    from crypto3_fil_proofs_torch.core.merkle import (
        StoreConfig,
        compact,
        create_lc_tree,
        get_merkle_tree_cache_size,
        split_config_and_replica,
    )
    from crypto3_fil_proofs_torch.core.utilities import default_rows_to_discard
    from crypto3_fil_proofs_torch.parameters import winning_post_public_params
    from crypto3_fil_proofs_torch.types import PrivateReplicaInfo

    config = post_config("winning", SECTOR_SIZE)
    leafs = SECTOR_SIZE // 32
    replicas = {SECTOR_ID: PrivateReplicaInfo(replica_path=run["sealed"], comm_r=run["p2"].comm_r,
                                              cache_dir=run["cache"])}
    pp = winning_post_public_params(config)
    _, vanilla = api_post.vanilla_proofs(config, pp, POST_RANDOMNESS, PROVER_ID, replicas, 1)
    full = vanilla[0].sectors[0].inclusion_proofs
    challenges = [p.leaf_index() for p in full]
    lc_dir = os.path.join(work, "lc")
    os.makedirs(lc_dir)
    shutil.copyfile(os.path.join(run["cache"], "sc-02-data-tree-r-last.dat"),
                     os.path.join(lc_dir, "sc-02-data-tree-r-last.dat"))
    rtd = default_rows_to_discard(leafs, 8)
    cfgs, replica = split_config_and_replica(StoreConfig(lc_dir, "tree-r-last", rows_to_discard=rtd),
                                             run["sealed"], leafs, 1)
    compact(cfgs[0], leafs, 8)
    cached = os.path.getsize(cfgs[0].data_path())
    if cached != 32 * get_merkle_tree_cache_size(leafs, 8, rtd):
        raise AssertionError("the compacted store does not hold the cached rows only")
    tree = create_lc_tree(leafs, 8, 0, 0, cfgs, replica, "poseidon", DEVICE)
    # the main path: counts from 0 just before it, read just after it
    reset_counts()
    t0 = time.time()
    proofs = [tree.gen_proof(c) for c in challenges]
    torch_sync()
    wall = time.time() - t0
    launches = all_counts()
    if proofs != full:
        raise AssertionError("LevelCache proofs != the full store's")
    if launches["poseidon_a8"] != len(challenges) * rtd:
        raise AssertionError(f"{launches['poseidon_a8']} K2 launches for {len(challenges)} proofs rebuilding "
                             f"{rtd} rows each")
    shutil.rmtree(lc_dir)
    log(f"phase 17: {len(proofs)} LevelCache proofs (rows_to_discard {rtd}, {cached} B cached of the full "
        f"store's) == the full store's, each rebuilding its {8 ** (rtd + 1)}-leaf segment on {DEVICE} in "
        f"{wall:.3f} s; launches {json.dumps({k: v for k, v in launches.items() if v})}")
    return {"launches": launches, "wall_s": wall, "rows_to_discard": rtd}


def phase_post_2k(work: str, run_2k: dict) -> None:
    """Phase 19: the 2 KiB sector of phase 4 proved with Winning (2 x 1)
    and Window (10 x 2) PoSt on cuda, each key made by setup in a
    private parameter cache: key digests and proof bytes == the frozen
    JAX golden (tests/golden/torch_post.json)."""
    from crypto3_fil_proofs_torch import caches
    from crypto3_fil_proofs_torch.api import post as api_post
    from crypto3_fil_proofs_torch.core.parameter_cache import params_path
    from crypto3_fil_proofs_torch.types import PrivateReplicaInfo, PublicReplicaInfo

    with open(os.path.join(REPO, "tests", "golden", "torch_post.json")) as f:
        golden = json.load(f)
    size = golden["sector_size"]
    comm_r = run_2k["p2"].comm_r
    if comm_r.hex() != golden["comm_r"]:
        raise AssertionError("phase 4's 2 KiB comm_r != the PoSt golden's")
    replicas = {SECTOR_ID: PrivateReplicaInfo(replica_path=run_2k["sealed"], comm_r=comm_r,
                                              cache_dir=run_2k["cache"])}
    rnd = bytes.fromhex(golden["randomness"])
    os.environ["FIL_PROOFS_PARAMETER_CACHE"] = os.path.join(work, "params_2k")
    caches.clear_caches()
    for kind in ("winning", "window"):
        g = golden[kind]
        config = post_config("winning_2KiB" if kind == "winning" else "window", size)
        generate = api_post.generate_winning_post if kind == "winning" else api_post.generate_window_post
        verify = api_post.verify_winning_post if kind == "winning" else api_post.verify_window_post
        t0 = time.time()
        proof = generate(config, rnd, replicas, PROVER_ID, device=DEVICE)
        wall = time.time() - t0
        prefix = post_prefix(config)
        if prefix != g["cache_prefix"] or key_digest(params_path(prefix)) != g["key_digest"]:
            raise AssertionError(f"2 KiB {kind} PoSt key != the JAX package's")
        if proof.hex() != g["proof"]:
            raise AssertionError(f"2 KiB {kind} PoSt proof != the JAX package's bytes")
        if not verify(config, rnd, {SECTOR_ID: PublicReplicaInfo(comm_r=comm_r)}, PROVER_ID, proof):
            raise AssertionError(f"2 KiB {kind} PoSt proof does not verify")
        log(f"phase 19: 2 KiB {kind} PoSt ({config.challenge_count} x {config.sector_count}) on {DEVICE} in "
            f"{wall:.1f} s: key digest and proof bytes == the JAX package's; verifies")
    caches.clear_caches()


# ---------------------------------------------------------------------------
# Phases 23-25: the legacy protocols (DRG PoRep, Election and Rational PoSt)
# ---------------------------------------------------------------------------

DRG_GOLDEN = os.path.join(REPO, "tests", "golden", "drg8")
DRG_SETUP_SEED = b"fil-tpu-setup"  # scripts/drg_groth16_e2e.py's
DRG_RANDOMNESS = b"drg-groth16-e2e-fixed"
ELECTION_CHALLENGES = 40  # x 1 node: the shipped election PoSt's POST_CHALLENGE_COUNT / CHALLENGED_NODES
ELECTION_RANDOMNESS = bytes([45] * 31 + [0])
LEGACY_STAGES = ("setup_blank_circuit", "setup_finalize", "setup_qap", "setup_scalars", "setup_fixed_base_g1",
                 "setup_fixed_base_g2", "setup_save", "commit_synthesis", "commit_check", "prove_finalize",
                 "prove_evals", "prove_h", "prove_to_device", "prove_msm_a", "prove_msm_b_g1", "prove_msm_b_g2",
                 "prove_msm_h", "prove_msm_l", "prove_assembly")


def traced_groth16(what: str, compound, pp, pub, vanilla, seed, randomness: bytes, tag: str,
                   required=GROTH16_PATH) -> dict:
    """get_params (setup in the caller's private cache) and prove on cuda,
    traced, the counts from 0 just before and read just after; stage
    times, launches, device busy share and peak memory. Every kernel in
    `required` must have launched."""
    import torch

    from crypto3_fil_proofs_torch.core.measure import measurements
    from crypto3_fil_proofs_torch.core.parameter_cache import meta_path, params_path

    torch_sync()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    state = {}

    def path():
        t0 = time.time()
        state["pk"] = compound.get_params(pp, seed=seed, device=DEVICE)
        torch_sync()
        state["setup_s"] = time.time() - t0
        state["multi"] = compound.prove(pp, pub, [vanilla], state["pk"], randomness=randomness, device=DEVICE)
        torch_sync()
        state["wall_s"] = time.time() - t0

    # the path: counts from 0 just before it, read just after it
    reset_counts()
    traced = trace_device(path)
    launches = all_counts()
    peak = torch.cuda.max_memory_allocated() - held
    spans = measurements()
    prefix = compound.adapter.cache_prefix(pp)
    with open(meta_path(prefix)) as f:
        meta = json.load(f)
    pk = state["pk"]
    log(f"  {what}: setup and prove on {DEVICE} in {state['wall_s']:.1f} s (setup {state['setup_s']:.1f} s): "
        f"{meta['num_constraints']} constraints, {meta['num_inputs']} inputs, domain 2^{pk.log_n}; key "
        f"{pk.nbytes()} B on the card, {os.path.getsize(params_path(prefix))} B on disk")
    log("  stages s " + json.dumps({k: round(spans[k], 3) for k in LEGACY_STAGES}))
    log(f"  launches {json.dumps({k: v for k, v in launches.items() if v})}; max_memory_allocated of the path "
        f"{peak} B")
    log_trace(f"{what} (setup and prove)", traced)
    for name in required:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{name} was not launched on the {tag} path")
    return {"launches": launches, "trace": traced, "peak_bytes": peak, "pk": pk, "multi": state["multi"],
            "prefix": prefix, "constraints": meta["num_constraints"], "log_n": pk.log_n,
            "stages": {k: spans[k] for k in LEGACY_STAGES}, "wall_s": state["wall_s"]}


def verify_bytes(compound, pp, pub, proof: bytes, vk) -> bool:
    """compound.verify of one partition's proof bytes; bytes that do not
    decode to curve points are refused."""
    from crypto3_fil_proofs_torch.core.compound import MultiProof

    try:
        multi = MultiProof.from_bytes(proof, 1)
    except ValueError:
        return False
    return compound.verify(pp, pub, multi, vk)


def first_difference(got: dict, want: dict) -> str | None:
    """The first array (in name order) where two npz files differ."""
    import numpy as np

    for k in sorted(set(got) | set(want)):
        if k not in got or k not in want:
            return f"{k}: only in {'the golden' if k in want else 'the port'}"
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if a.shape != b.shape or a.dtype != b.dtype:
            return f"{k}: {a.dtype}{a.shape} against {b.dtype}{b.shape}"
        if not np.array_equal(a, b):
            idx = np.argwhere(a != b)[0].tolist()
            return f"{k}: first at {idx}"
    return None


def phase_drg(work: str) -> dict:
    """Phase 23: DRG PoRep of the drg8 instance (8 nodes, degree 6, one
    challenge; 1,989,928 constraints, 2^21) remade as
    scripts/drg_groth16_e2e.py makes it: replication on the host ==
    tests/golden/drg8's commitments, extract_all gives the data back, the
    vanilla proof verifies; then get_params (setup seeded as the script
    seeds it, a private cache) and prove on cuda, traced, the counts from
    0: the vk == the golden's vk.npz array for array, the 192 bytes ==
    proof.bin; it verifies, a flipped bit and a wrong replica id do not."""
    import numpy as np

    from crypto3_fil_proofs_torch import caches
    from crypto3_fil_proofs_torch.core.compound import CompoundProof
    from crypto3_fil_proofs_torch.core.parameter_cache import vk_path
    from crypto3_fil_proofs_torch.models.porep.drg import circuit as dcirc
    from crypto3_fil_proofs_torch.models.porep.drg import vanilla as drg

    with open(os.path.join(DRG_GOLDEN, "inputs.json")) as f:
        golden = json.load(f)
    with open(os.path.join(DRG_GOLDEN, "proof.bin"), "rb") as f:
        golden_proof = f.read()
    nodes = golden["nodes"]
    t0 = time.time()
    pp = drg.DrgPoRep.setup(drg.SetupParams(
        drg=drg.DrgParams(nodes=nodes, degree=golden["degree"], expansion_degree=0,
                          seed=bytes.fromhex(golden["drg_seed"])),
        challenges_count=len(golden["challenges"])))
    rng = np.random.default_rng(0x5EED)
    data = rng.integers(0, 64, size=(nodes, 32), dtype=np.uint8)
    replica_id = bytes(rng.integers(0, 64, size=32, dtype=np.uint8))
    tau, aux, replica = drg.DrgPoRep.replicate(pp, replica_id, data)
    if (replica_id.hex(), tau.comm_d.hex(), tau.comm_r.hex()) != \
            (golden["replica_id"], golden["comm_d"], golden["comm_r"]):
        raise AssertionError("drg8 replica id or commitments != tests/golden/drg8/inputs.json")
    if not np.array_equal(drg.DrgPoRep.extract_all(pp, replica_id, replica), data):
        raise AssertionError("drg8 extract_all != the data")
    pub = drg.PublicInputs(replica_id=replica_id, challenges=golden["challenges"], tau=tau)
    vanilla = drg.DrgPoRep.prove(pp, pub, drg.PrivateInputs(tree_d=aux.tree_d, tree_r=aux.tree_r))
    if not drg.DrgPoRep.verify(pp, pub, vanilla):
        raise AssertionError("drg8 vanilla proof does not verify")
    host_s = time.time() - t0
    log(f"phase 23: drg8 replicated on the host: comm_d {tau.comm_d.hex()} comm_r {tau.comm_r.hex()} == the golden; "
        f"extract_all gives the data back; the vanilla proof verifies ({host_s:.3f} s)")

    os.environ["FIL_PROOFS_PARAMETER_CACHE"] = os.path.join(work, "params_drg")
    caches.clear_caches()
    compound = CompoundProof(dcirc.DrgPoRepCompound())
    # every nonzero scalar of drg8's B query is a bit (1), so its G2 MSM
    # is the scalar-1 sum alone (K5 add, ops/msm.py `msm`): no bucket stage
    required = [k for k in GROTH16_PATH if not k.startswith("msm_g2_")]
    run = traced_groth16("drg8", compound, pp, pub, vanilla, DRG_SETUP_SEED, DRG_RANDOMNESS, "DRG", required)
    if any(run["launches"][k] for k in GROTH16_PATH if k.startswith("msm_g2_")):
        raise AssertionError("drg8's G2 MSM ran bucket stages: its B query has scalars other than 0 and 1")
    proof = run["multi"].to_bytes()
    vk = run["pk"].vk
    ok = compound.verify(pp, pub, run["multi"], vk)
    flipped = bytearray(proof)
    flipped[50] ^= 1
    bad_bit = verify_bytes(compound, pp, pub, bytes(flipped), vk)
    bad_id = compound.verify(pp, drg.PublicInputs(replica_id=bytes(32), challenges=pub.challenges, tau=tau),
                             run["multi"], vk)
    if len(proof) != 192 or not ok or bad_bit or bad_id:
        raise AssertionError(f"drg8 proof {len(proof)} B accepted {ok}, flipped bit {bad_bit}, wrong replica id "
                             f"{bad_id}")
    with np.load(vk_path(run["prefix"])) as d:
        got = {k: d[k] for k in d.files}
    with np.load(os.path.join(DRG_GOLDEN, "vk.npz")) as d:
        want = {k: d[k] for k in d.files}
    vk_diff = first_difference(got, want)
    log(f"phase 23: drg8 ({run['prefix']}) proved on {DEVICE}: it verifies, a flipped bit and a wrong replica id "
        f"do not; vk == tests/golden/drg8/vk.npz: {vk_diff is None}"
        + (f" ({vk_diff})" if vk_diff else f" ({len(got)} arrays)")
        + f"; proof == proof.bin: {proof == golden_proof}")
    if vk_diff or proof != golden_proof:
        raise AssertionError(f"drg8 vk or proof != tests/golden/drg8 (vk: {vk_diff}; proof {proof.hex()})")
    caches.clear_caches()
    del run["pk"], run["multi"]
    import torch

    torch.cuda.empty_cache()
    return run


def phase_election(work: str, run: dict) -> dict:
    """Phase 24: Election PoSt (40 challenges x 1 node) of the 512 MiB
    sector of phase 5 over its stored tree_r_last: sector challenges and
    candidates (host, hash_md), the vanilla proof; then get_params (a
    private cache) and prove on cuda, traced, the counts from 0; it
    verifies, a flipped bit and a wrong partial ticket do not. Then
    Rational PoSt (host): derive_challenges over the sector and a second
    one set faulty, prove and verify on the same tree; the faulty set
    naming the sector is refused."""
    import torch

    from crypto3_fil_proofs_torch import caches
    from crypto3_fil_proofs_torch.api import post as api_post
    from crypto3_fil_proofs_torch.core.compound import CompoundProof
    from crypto3_fil_proofs_torch.models.post.election import circuit as ecirc
    from crypto3_fil_proofs_torch.models.post.election import vanilla as election
    from crypto3_fil_proofs_torch.models.post.rational import vanilla as rational
    from crypto3_fil_proofs_torch.types import PrivateReplicaInfo

    replica = PrivateReplicaInfo(replica_path=run["sealed"], comm_r=run["p2"].comm_r, cache_dir=run["cache"])
    tree = api_post._replica_tree(post_config("winning", SECTOR_SIZE), replica)
    comm_c, comm_r_last = api_post._load_p_aux(replica)
    t0 = time.time()
    pp = election.ElectionPoSt.setup(election.SetupParams(SECTOR_SIZE, ELECTION_CHALLENGES, 1))
    sectors = election.generate_sector_challenges(ELECTION_RANDOMNESS, 1, [SECTOR_ID])
    cand = election.generate_candidates(pp, sectors, {SECTOR_ID: tree}, PROVER_ID, ELECTION_RANDOMNESS)[0]
    pub = election.PublicInputs(randomness=ELECTION_RANDOMNESS, sector_id=SECTOR_ID, prover_id=PROVER_ID,
                                comm_r=replica.comm_r, partial_ticket=cand.partial_ticket,
                                sector_challenge_index=cand.sector_challenge_index)
    vanilla = election.ElectionPoSt.prove(pp, pub, election.PrivateInputs(tree, comm_c, comm_r_last))
    if vanilla.ticket != cand.ticket or not election.ElectionPoSt.verify(pp, pub, vanilla):
        raise AssertionError("512 MiB election vanilla proof does not verify")
    host_s = time.time() - t0
    log(f"phase 24: election candidate of the {SECTOR_SIZE} B sector ({ELECTION_CHALLENGES} x 1): partial ticket "
        f"{cand.partial_ticket.hex()}, ticket {cand.ticket.hex()}; the vanilla proof verifies ({host_s:.3f} s, host)")

    os.environ["FIL_PROOFS_PARAMETER_CACHE"] = os.path.join(work, "params_election")
    caches.clear_caches()
    compound = CompoundProof(ecirc.ElectionPoStCompound(shape=(8, 0, 0)))
    out = traced_groth16(f"{SECTOR_SIZE} B election PoSt", compound, pp, pub, vanilla, None, b"election-post", "el")
    multi, vk = out["multi"], out["pk"].vk
    proof = multi.to_bytes()
    ok = compound.verify(pp, pub, multi, vk)
    flipped = bytearray(proof)
    flipped[7] ^= 1
    bad_bit = verify_bytes(compound, pp, pub, bytes(flipped), vk)
    wrong = election.PublicInputs(**{**pub.__dict__, "partial_ticket": bytes(32)})
    bad_ticket = compound.verify(pp, wrong, multi, vk)
    if len(proof) != 192 or not ok or bad_bit or bad_ticket:
        raise AssertionError(f"election proof {len(proof)} B accepted {ok}, flipped bit {bad_bit}, wrong partial "
                             f"ticket {bad_ticket}")
    log(f"phase 24: election PoSt ({out['prefix']}) proved on {DEVICE}: the 192-byte proof verifies, a flipped bit "
        "and a wrong partial ticket do not")
    caches.clear_caches()
    del out["pk"], out["multi"]
    torch.cuda.empty_cache()

    t0 = time.time()
    faulty = SECTOR_ID + 1
    rpp = rational.RationalPoSt.setup(rational.SetupParams(SECTOR_SIZE, ELECTION_CHALLENGES))
    challenges = rational.derive_challenges(ELECTION_CHALLENGES, SECTOR_SIZE, [SECTOR_ID, faulty],
                                            ELECTION_RANDOMNESS, {faulty})
    if any(c.sector != SECTOR_ID for c in challenges):
        raise AssertionError("rational challenges name the faulty sector")
    rpub = rational.PublicInputs(challenges=challenges, faults={faulty}, comm_rs={SECTOR_ID: replica.comm_r})
    rproof = rational.RationalPoSt.prove(rpp, rpub, rational.PrivateInputs(
        trees={SECTOR_ID: tree}, comm_c={SECTOR_ID: comm_c}, comm_r_last={SECTOR_ID: comm_r_last}))
    ok = rational.RationalPoSt.verify(rpp, rpub, rproof)
    refused = rational.RationalPoSt.verify(rpp, rational.PublicInputs(challenges, {SECTOR_ID}, rpub.comm_rs), rproof)
    if not ok or refused:
        raise AssertionError(f"rational PoSt accepted {ok}, with the sector faulty {refused}")
    log(f"phase 24: rational PoSt ({ELECTION_CHALLENGES} challenges over the sector, sector {faulty} faulty) proved "
        f"and verified on the host in {time.time() - t0:.3f} s; the fault set naming the sector is refused")
    return out


def phase_election_2k(work: str, run_2k: dict) -> None:
    """Phase 25: the 2 KiB Election PoSt (2 x 1) of phase 4's sector, its
    key made by setup in a private cache on cuda: the candidate, the key
    digest, the verifying key (array for array) and the proof bytes under
    fixed randomness == the
    frozen JAX golden (tests/golden/torch_election_2k.json); it verifies."""
    import numpy as np

    from crypto3_fil_proofs_torch import caches
    from crypto3_fil_proofs_torch.api import post as api_post
    from crypto3_fil_proofs_torch.core.compound import CompoundProof
    from crypto3_fil_proofs_torch.core.parameter_cache import params_path, vk_path
    from crypto3_fil_proofs_torch.models.post.election import circuit as ecirc
    from crypto3_fil_proofs_torch.models.post.election import vanilla as election
    from crypto3_fil_proofs_torch.types import PrivateReplicaInfo

    with open(os.path.join(REPO, "tests", "golden", "torch_election_2k.json")) as f:
        g = json.load(f)
    size = g["sector_size"]
    if run_2k["p2"].comm_r.hex() != g["comm_r"]:
        raise AssertionError("phase 4's 2 KiB comm_r != the election golden's")
    replica = PrivateReplicaInfo(replica_path=run_2k["sealed"], comm_r=run_2k["p2"].comm_r,
                                 cache_dir=run_2k["cache"])
    tree = api_post._replica_tree(post_config("winning_2KiB", size), replica)
    comm_c, comm_r_last = api_post._load_p_aux(replica)
    prover_id, rnd = bytes.fromhex(g["prover_id"]), bytes.fromhex(g["randomness"])
    t0 = time.time()
    pp = election.ElectionPoSt.setup(election.SetupParams(size, g["challenge_count"], g["challenged_nodes"]))
    cand = election.generate_candidate(pp, tree, prover_id, g["sector_id"], rnd, g["sector_challenge_index"])
    if (cand.partial_ticket.hex(), cand.ticket.hex()) != (g["partial_ticket"], g["ticket"]):
        raise AssertionError("2 KiB election candidate != the JAX package's")
    pub = election.PublicInputs(randomness=rnd, sector_id=g["sector_id"], prover_id=prover_id,
                                comm_r=replica.comm_r, partial_ticket=cand.partial_ticket,
                                sector_challenge_index=g["sector_challenge_index"])
    vanilla = election.ElectionPoSt.prove(pp, pub, election.PrivateInputs(tree, comm_c, comm_r_last))
    os.environ["FIL_PROOFS_PARAMETER_CACHE"] = os.path.join(work, "params_election_2k")
    caches.clear_caches()
    compound = CompoundProof(ecirc.ElectionPoStCompound(shape=(8, 0, 0)))
    pk = compound.get_params(pp, device=DEVICE)
    multi = compound.prove(pp, pub, [vanilla], pk, randomness=bytes.fromhex(g["proof_randomness"]), device=DEVICE)
    wall = time.time() - t0
    prefix = compound.adapter.cache_prefix(pp)
    with np.load(vk_path(prefix)) as d:
        got = {k: d[k] for k in d.files}
    with np.load(io.BytesIO(bytes.fromhex(g["vk_npz"]))) as d:  # the JAX package writes it compressed
        want = {k: d[k] for k in d.files}
    if prefix != g["cache_prefix"] or key_digest(params_path(prefix)) != g["key_digest"] \
            or first_difference(got, want):
        raise AssertionError(f"2 KiB election key != the JAX package's (vk: {first_difference(got, want)})")
    if multi.to_bytes().hex() != g["proof"]:
        raise AssertionError("2 KiB election proof != the JAX package's bytes")
    if not compound.verify(pp, pub, multi, pk.vk):
        raise AssertionError("2 KiB election proof does not verify")
    log(f"phase 25: 2 KiB election PoSt ({g['challenge_count']} x {g['challenged_nodes']}) on {DEVICE} in {wall:.1f} s: "
        "candidate, key digest, verifying key and proof bytes == the JAX package's; verifies")
    caches.clear_caches()


# ---------------------------------------------------------------------------
# Phases 26-30: the multi-device layer (parallel/): the golden shapes on an
# 8-shard mesh, the sharded tree, NTT and MSMs at full width (path `sh`),
# K3b's batched rows, prove_many (`pm`) and seal_many (`sm`)
# ---------------------------------------------------------------------------

MESH_SHARDS = 8
COMMIT_LOG_N = 23  # the 512 MiB commit's QAP domain
# the kernels each new path must launch
SH_PATH = ["fr_montmul", "poseidon_a2", "poseidon_a8", "ntt_rows", "g1_add", "g1_dbl", "g2_add", "g2_dbl"] + [
    f"msm_{g}_{op}" for g in ("g1", "g2") for op in ("bucket_acc", "bucket_reduce", "agg_level")]
SM_PATH = ["fr_montmul", "poseidon_a2", "poseidon_a8"]


def mesh_line(mesh) -> str:
    import torch

    return (f"mesh of {mesh.shards} shards on {mesh.cards} distinct card(s) "
            f"({', '.join(str(d) for d in mesh.devices)}); torch.cuda.device_count() {torch.cuda.device_count()}")


def counted(fn) -> dict:
    """fn() once, traced, with the counts set to 0 just before it and read
    just after it; its wall (traced), device time and peak memory."""
    import torch

    torch_sync()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    state = {}
    reset_counts()
    tr = trace_device(lambda: state.setdefault("out", fn()))
    return {"out": state["out"], "launches": all_counts(), "trace": tr, "wall_s": tr["wall_s"],
            "device_s": tr["device_s"], "peak_bytes": torch.cuda.max_memory_allocated() - held}


def merge_counted(*runs: dict) -> dict:
    """One path's launches, trace and peak memory from several counted runs."""
    launches = {}
    for r in runs:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"launches": launches, "trace": merge_traces(*(r["trace"] for r in runs)),
            "peak_bytes": max(r["peak_bytes"] for r in runs)}


def summary(r: dict) -> dict:
    return {"wall_s": r["wall_s"], "device_s": r["device_s"], "peak_bytes": r["peak_bytes"],
            "launches": {k: v for k, v in r["launches"].items() if v}}


def side_by_side(what: str, sharded: dict, single: dict) -> dict:
    """Log the sharded run beside the single-device call's."""
    fmt = lambda r: (f"wall {r['wall_s']:.3f} s, device {r['device_s'] or 0:.4f} s, peak {r['peak_bytes']} B, "
                     f"{sum(r['launches'].values())} launches")
    log(f"  {what}: sharded {fmt(sharded)}; single device {fmt(single)} (both traced)")
    return {"sharded": summary(sharded), "single": summary(single)}


def require(path: str, launches: dict, names) -> None:
    for name in names:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{name} was not launched on the {path} path")


def golden_sharded():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_sharded_ref as ref

    with open(ref.GOLDEN) as f:
        return ref, json.load(f)


def phase_mesh_golden() -> None:
    """Phase 26: the mesh (its shards, its distinct cards and the card
    count), and the sharded tree, NTT (forward, inverse) and G1 MSM on
    an 8-shard CUDA mesh at the shapes of the frozen JAX golden
    (tests/golden/torch_sharded.json) == it; make_mesh gives CUDA devices
    only."""
    import torch

    from crypto3_fil_proofs_torch.ops import field as F
    from crypto3_fil_proofs_torch.ops.bls12_381 import g1_to_compressed
    from crypto3_fil_proofs_torch.ops.g1_torch import G1
    from crypto3_fil_proofs_torch.parallel import sharded as S

    ref, golden = golden_sharded()
    mesh = S.make_mesh(MESH_SHARDS)
    if any(d.type != "cuda" for d in mesh.devices):
        raise AssertionError(f"make_mesh gave {mesh.devices}")
    log("phase 26: " + mesh_line(mesh))
    inp = ref.inputs()
    roots, top = S.build_tree_sharded(F.ints_to_limbs32(inp["leaves"]).cuda(), ref.TREE_ARITY, mesh)
    hexes = [v.to_bytes(32, "little").hex() for v in F.limbs32_to_ints(torch.cat([roots, top[None]]).cpu())]
    if hexes != golden["tree"]["sub_roots"] + [golden["tree"]["top"]]:
        raise AssertionError("build_tree_sharded on the card != the JAX golden")
    fwd = S.ntt_sharded(F.ints_to_limbs32(inp["ntt"]).cuda(), ref.NTT_LOG_N, mesh)
    inv = S.ntt_sharded(fwd, ref.NTT_LOG_N, mesh, inverse=True)
    if [ref.digest_values(F.limbs32_to_ints(t.cpu())) for t in (fwd, inv)] != [golden["ntt"]["forward"],
                                                                              golden["ntt"]["inverse"]]:
        raise AssertionError("ntt_sharded on the card != the JAX golden")
    aff, _ = G1.points_to_device(inp["points"])
    point = S.msm_sharded(aff.cuda(), F.ints_to_limbs32(inp["scalars"]).cuda(), mesh, n_buckets=ref.MSM_BUCKETS)
    if g1_to_compressed(point).hex() != golden["msm"]["result"]:
        raise AssertionError("G1 msm_sharded on the card != the JAX golden")
    log(f"phase 26: on the {MESH_SHARDS}-shard mesh, build_tree_sharded ({ref.TREE_LEAVES} leaves, arity "
        f"{ref.TREE_ARITY}), ntt_sharded (2^{ref.NTT_LOG_N}, forward and inverse) and G1 msm_sharded "
        f"({ref.MSM_POINTS} points, {ref.MSM_BUCKETS} buckets) == the frozen JAX golden")


def phase_sharded_tree_ntt(run: dict, gen) -> dict:
    """Phase 27 (path `sh`, first half): build_tree_sharded over phase 5's
    512 MiB replica (2^24 leaves, arity 8) on the 8-shard mesh: its
    sub-roots == tree_r_last's stored level of 8 nodes, top == the host
    Poseidon-2 fold of them; ntt_sharded at 2^23, forward and inverse, on
    seeded Montgomery vectors == the single-device K3 ntt / intt. Each
    run counted and traced beside the single-device call's."""
    import numpy as np
    import torch

    from crypto3_fil_proofs_torch.ops.cuda import ntt as k3
    from crypto3_fil_proofs_torch.ops.poseidon import poseidon_hash
    from crypto3_fil_proofs_torch.ops.poseidon_torch import bytes_to_mont, hash_level, mont_to_bytes
    from crypto3_fil_proofs_torch.parallel import sharded as S

    mesh = S.make_mesh(MESH_SHARDS)
    nodes = SECTOR_SIZE // 32
    leaves = bytes_to_mont(torch.from_numpy(np.fromfile(run["sealed"], dtype=np.uint8).reshape(nodes, 32)).cuda())
    tree = counted(lambda: S.build_tree_sharded(leaves, 8, mesh))
    roots, top = tree.pop("out")

    def single_tree():
        level = leaves
        while level.shape[0] > MESH_SHARDS:
            level = hash_level(level, 8)
        return level

    one = counted(single_tree)
    off, n = next(lv for lv in _level_offsets(nodes, 8) if lv[1] == MESH_SHARDS)
    store = np.memmap(os.path.join(run["cache"], "sc-02-data-tree-r-last.dat"), dtype=np.uint8, mode="r")
    stored = store.reshape(-1, 32)[off : off + n].tobytes()
    got = mont_to_bytes(roots).cpu().numpy().tobytes()
    if got != stored or not torch.equal(roots, one.pop("out")):
        raise AssertionError("the sharded sub-roots of the 512 MiB replica != tree_r_last's stored level of 8")
    fold = [int.from_bytes(got[32 * i : 32 * i + 32], "little") for i in range(n)]
    while len(fold) > 1:
        fold = [poseidon_hash(fold[i : i + 2], 2) for i in range(0, len(fold), 2)]
    if mont_to_bytes(top[None]).cpu().numpy().tobytes() != fold[0].to_bytes(32, "little"):
        raise AssertionError("the sharded top != the host Poseidon-2 fold of the sub-roots")
    log(f"phase 27: build_tree_sharded of the {SECTOR_SIZE} B replica ({nodes} leaves, arity 8) on the "
        f"{MESH_SHARDS}-shard mesh: the sub-roots == tree_r_last's stored level of {n} nodes; top == the host "
        "Poseidon-2 fold of them")
    out = {"tree": side_by_side("tree", tree, one)}
    del leaves, roots, top, store
    torch.cuda.empty_cache()

    a = rand_fr_mont(1 << COMMIT_LOG_N, gen)
    for dev in mesh.distinct():  # the path's tables, made before its runs
        for inverse in (False, True):
            S.inter_step(COMMIT_LOG_N, inverse, str(dev))
    runs = {}
    for inverse, name in ((False, "ntt_forward"), (True, "ntt_inverse")):
        sharded = counted(lambda: S.ntt_sharded(a, COMMIT_LOG_N, mesh, inverse=inverse))
        single = counted(lambda: (k3.intt if inverse else k3.ntt)(a, COMMIT_LOG_N))
        check_equal(f"ntt_sharded 2^{COMMIT_LOG_N} {name}", sharded.pop("out"), single.pop("out"))
        out[name] = side_by_side(name.replace("_", " "), sharded, single)
        runs[name] = sharded
    log_r, log_c = S.split(COMMIT_LOG_N)
    out["k3_ms"] = cuda_ms(lambda: k3.transform(a, COMMIT_LOG_N, False), 5)
    out["k3_device_ms"] = k3_device_ms(lambda: k3.transform(a, COMMIT_LOG_N, False), 5)
    out["k3_passes"] = k3.plan(COMMIT_LOG_N, 1, a.device)
    out["k3_radix_log"] = k3.radix_log(1 << COMMIT_LOG_N, a.device)
    log(f"phase 27: the single-device K3 ntt / intt at 2^{COMMIT_LOG_N} == ntt_sharded (K3b's four-step, R = "
        f"2^{log_r} rows, C = 2^{log_c} columns), forward and inverse, on seeded Montgomery vectors; K3's "
        f"transform {out['k3_ms']:.4f} ms")
    for name, r in runs.items():
        ms = path_ms("ntt_rows", r["trace"])
        log(f"  {name.replace('_', ' ')} sharded: K3b {r['launches'].get('ntt_rows', 0)} launches, "
            f"{'not measured' if ms is None else f'{ms:.4f} ms'} of device time; K3 {r['launches'].get('ntt', 0)} "
            "launches")
    out["path_runs"] = [tree] + list(runs.values())
    del a
    S.inter_step.cache_clear()
    torch.cuda.empty_cache()
    return out


def phase_sharded_msm(pk, seed: int) -> dict:
    """Phase 28 (path `sh`, second half), while the 512 MiB key is on the
    card: G1 msm_sharded over its h_query (2^23 - 1 points) and G2 over
    its b_g2_query on the 8-shard mesh, with seeded scalars (0 on the
    query's invalid lanes), == the single-device msm; each counted and
    traced beside the single-device call's."""
    import torch

    from crypto3_fil_proofs_torch.ops import field as F
    from crypto3_fil_proofs_torch.ops import msm as M
    from crypto3_fil_proofs_torch.ops.bls12_381 import g1_eq, g2_eq
    from crypto3_fil_proofs_torch.ops.g1_torch import G1
    from crypto3_fil_proofs_torch.ops.g2_torch import G2
    from crypto3_fil_proofs_torch.parallel import sharded as S

    mesh = S.make_mesh(MESH_SHARDS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 28)
    out, runs = {}, []
    for name, curve, query, eq in (("g1", G1, pk.h_query, g1_eq), ("g2", G2, pk.b_g2_query, g2_eq)):
        pts, valid = query
        sc = torch.where(valid[:, None], rand_elems(F.FR, pts.shape[0], gen), 0)
        sharded = counted(lambda: S.msm_sharded(pts, sc, mesh, curve=name))
        single = counted(lambda: M.msm(curve, pts, sc))
        if not eq(sharded.pop("out"), single.pop("out")):
            raise AssertionError(f"{name} msm_sharded over the 512 MiB key != the single-device msm")
        log(f"phase 28: {name} msm_sharded over the 512 MiB key's {'h_query' if name == 'g1' else 'b_g2_query'} "
            f"({pts.shape[0]} points, {int(valid.sum())} valid; 2^16 buckets) on the {MESH_SHARDS}-shard mesh == "
            "the single-device msm")
        out[f"msm_{name}"] = side_by_side(f"{name} msm", sharded, single)
        out[f"msm_{name}"]["points"] = pts.shape[0]
        runs.append(sharded)
        del sc
        torch.cuda.empty_cache()
    out["path_runs"] = runs
    return out


# (log_n, batch) of the batched transform's edge shapes in phase 29: for
# K3b one row, the shortest rows, stage counts that leave a radix-2 or
# radix-4 trip after the radix-8 ones, rows shorter than a warp's
# butterflies, more rows than the card holds blocks at once, and one row
# of 2^12 at the shared-memory limit; then rows of 2^13, longer than K3b
# takes, for K3's batched passes
ROWS_EDGE_SHAPES = ((1, 1), (1, 3), (2, 5), (3, 2), (5, 1), (7, 9), (10, 1100), (12, 1), (13, 3))


def phase_ntt_batched(gen) -> dict:
    """Phase 29: K3b (csrc/ntt_rows.cu) at the four-step shapes of 2^23 on
    8 shards (a shard's 256 columns of 2^12 and 512 rows of 2^11): one
    launch a batch and none of K3's; forward and inverse against the plain
    transform (every 61st row and the last); its time, bound and share.
    Then the edge shapes (ROWS_EDGE_SHAPES), every row, both directions,
    against the plain transform: one K3b launch a batch, and for rows of
    2^13 one launch of K3's batched pass kernel a pass and none of K3b."""
    from crypto3_fil_proofs_torch.ops import field as F
    from crypto3_fil_proofs_torch.ops import ntt as N
    from crypto3_fil_proofs_torch.ops.cuda import ntt as k3
    from crypto3_fil_proofs_torch.parallel import sharded as S

    log_r, log_c = S.split(COMMIT_LOG_N)
    shapes = []
    for log_n, batch in ((log_r, (1 << log_c) // MESH_SHARDS), (log_c, (1 << log_r) // MESH_SHARDS)):
        x = rand_fr_mont(batch << log_n, gen).reshape(batch, 1 << log_n, F.FR.n32)
        rows = list(range(0, batch, 61)) + [batch - 1]
        err, plain_ms = 0, 0.0
        for inverse in (False, True):
            what = f"K3b {'inverse' if inverse else 'forward'}, {batch} x 2^{log_n}"
            got = batched_launches(k3, what, lambda: k3.transform(x, log_n, inverse), 1, 0)
            for r in rows:
                want, ms = timed(lambda: N.transform_plain(x[r], log_n, inverse))
                plain_ms += ms
                err = max(err, check_equal(f"{what}, row {r}", got[r], want))
        ms = cuda_ms(lambda: k3.transform(x, log_n, False), 20)
        n = batch << log_n
        b_ms, b_by = bound_ms(2 * n * 32 + (1 << log_n) // 2 * 32,
                              batch * ntt_products(log_n) * montmul_mads(F.FR.n32))
        shapes.append({"log_n": log_n, "batch": batch, "ms": ms, "plain_ms": plain_ms / (2 * len(rows)),
                       "plain_rows": 2 * len(rows), "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
                       "share": b_ms / ms, "launches_per_batch": 1})
        log(f"phase 29: K3b == plain on {len(rows)} of {batch} rows of 2^{log_n}, forward and inverse: {ms:.4f} ms "
            f"for the batch (one launch) against a bound of {b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f} %; plain "
            f"{plain_ms / (2 * len(rows)):.2f} ms a row")
        del x, got
    for log_n, batch in ROWS_EDGE_SHAPES:
        n = batch << log_n
        rows_kernel = log_n <= k3.ROWS_MAX_LOG_N
        x = rand_fr_mont(max(n, 3), gen)[:n].reshape(batch, 1 << log_n, F.FR.n32)
        for inverse in (False, True):
            want = N.transform_plain(x, log_n, inverse).reshape(-1, F.FR.n32)
            what = (f"{'K3b' if rows_kernel else 'K3 batched'} {'inverse' if inverse else 'forward'}, "
                    f"{batch} x 2^{log_n}")
            got = batched_launches(k3, what, lambda: k3.transform(x, log_n, inverse), int(rows_kernel),
                                   0 if rows_kernel else len(k3.plan(log_n, batch, DEVICE)))
            check_equal(what, got.reshape(-1, F.FR.n32), want)
    log(f"phase 29: the batched transform == plain at the edge shapes (log_n, batch) {list(ROWS_EDGE_SHAPES)}, "
        f"every row, forward and inverse; K3b up to 2^{k3.ROWS_MAX_LOG_N}, K3's batched passes above")
    return {"shapes": shapes}


def batched_launches(k3, what: str, fn, rows: int, passes: int):
    """fn()'s result, after checking that it launched K3b `rows` times and
    K3's pass kernel `passes` times."""
    before = dict(k3.launches)
    out = fn()
    got = (k3.launches["ntt_rows"] - before["ntt_rows"], k3.launches["ntt"] - before["ntt"])
    if got != (rows, passes):
        raise AssertionError(f"{what}: {got[0]} K3b and {got[1]} K3 launches, not {rows} and {passes}")
    return out


def phase_prove_many(work: str, run: dict) -> dict:
    """Phase 30 (path `pm`): generate_window_post over four replicas of
    phase 5's sector (two partitions of 10 x 2) under phase 18's cached
    key, through compound.prove and so prove_many on every card; then the
    same circuits through prove_many on a 2-shard mesh (two threads
    sharing the card when there is one). Both runs counted and traced;
    the bytes of both == the serial per-partition prove, and the proof
    verifies. On one card the every-card run is the serial loop itself
    (prove_many proves in the calling thread), so no third run is made."""
    import torch

    from crypto3_fil_proofs_torch import caches
    from crypto3_fil_proofs_torch.api import post as api_post
    from crypto3_fil_proofs_torch.parallel import sharded as S
    from crypto3_fil_proofs_torch.types import PrivateReplicaInfo, PublicReplicaInfo
    from crypto3_fil_proofs_torch.zk import groth16

    os.environ["FIL_PROOFS_PARAMETER_CACHE"] = os.path.join(work, "params_window")
    caches.clear_caches()
    config = post_config("window", SECTOR_SIZE)
    comm_r = run["p2"].comm_r
    ids = [SECTOR_ID + i for i in range(4)]
    replicas = {i: PrivateReplicaInfo(replica_path=run["sealed"], comm_r=comm_r, cache_dir=run["cache"]) for i in ids}
    with CallTimer(groth16, "prove") as rec:  # each partition's proof, with its circuit
        every = counted(lambda: api_post.generate_window_post(config, POST_RANDOMNESS, replicas, PROVER_ID,
                                                              device=DEVICE))
    every_batches = witness_batches()
    proof = every.pop("out")
    calls = sorted(rec.args, key=lambda c: c[1]["randomness"][-1])  # in partition order
    pk, cs_list = calls[0][0][0], [a[1] for a, _ in calls]
    randomness = calls[0][1]["randomness"][:-1]
    mesh = S.make_mesh(2)
    two = counted(lambda: groth16.prove_many(pk, cs_list, randomness=randomness, devices=mesh))
    if S.make_mesh().shards == 1:
        # one card: compound.prove's prove_many ran the serial
        # per-partition loop, in this thread
        want, serial_s = proof, None
    else:
        t0 = time.time()
        serial = [groth16.prove(pk, cs, randomness=randomness + bytes([k])) for k, cs in enumerate(cs_list)]
        torch_sync()
        serial_s = time.time() - t0
        want = b"".join(p.to_bytes() for p in serial)
    got_two = b"".join(p.to_bytes() for p in two.pop("out"))
    pub = {i: PublicReplicaInfo(comm_r=comm_r) for i in ids}
    ok = api_post.verify_window_post(config, POST_RANDOMNESS, pub, PROVER_ID, proof)
    if len(cs_list) != 2 or proof != want or got_two != want or not ok:
        raise AssertionError(f"prove_many: {len(cs_list)} partitions, compound bytes == serial {proof == want}, "
                             f"2-shard bytes == serial {got_two == want}, verifies {ok}")
    busy = lambda r: 100 * (r["device_s"] or 0) / r["wall_s"]
    log(f"phase 30: window PoSt over 4 replicas ({len(cs_list)} partitions) through compound.prove -> "
        f"prove_many on every card ({mesh_line(S.make_mesh())}) in "
        f"{every['wall_s']:.1f} s (device busy {busy(every):.1f} %), prove_many on a 2-shard mesh in "
        f"{two['wall_s']:.1f} s (busy {busy(two):.1f} %), "
        + ("the every-card run being the serial per-partition prove on this one card: "
           if serial_s is None else f"the serial per-partition prove in {serial_s:.1f} s: ")
        + f"the {len(proof)} bytes of all are equal, and the proof verifies; K7's batches in the every-card run "
        f"[arity, instances, calls] {json.dumps(every_batches)}")
    for r in (every, two):
        require("pm", r["launches"], GROTH16_PATH[:1] + GROTH16_PATH[2:])
    require("pm (synthesis)", every["launches"], ["poseidon_witness"])
    caches.clear_caches()
    torch.cuda.empty_cache()
    return {"launches": merge_counted(every, two)["launches"], "trace": merge_traces(every["trace"], two["trace"]),
            "peak_bytes": max(every["peak_bytes"], two["peak_bytes"]), "every": summary(every),
            "two_shards": summary(two), "serial_s": serial_s, "partitions": len(cs_list),
            "witness_batches": every_batches}


class HostPeak:
    """Peak resident memory of this process while active, sampled from
    /proc/self/statm every 0.2 s."""

    def __enter__(self):
        import threading

        self.peak, self._stop = 0, threading.Event()
        page = os.sysconf("SC_PAGE_SIZE")

        def sample():
            while not self._stop.wait(0.2):
                with open("/proc/self/statm") as f:
                    self.peak = max(self.peak, int(f.read().split()[1]) * page)

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def phase_seal_many(work: str, run: dict) -> dict:
    """Phase 31 (path `sm`): seal_many of two 512 MiB jobs with two
    labeling workers, after the unseal thread of phase 16 has joined,
    counted and traced, its trees on disk. Job A is phase 5's data and
    replica id: its comm_d, comm_c, comm_r_last, comm_r and replica
    digest == phase 5's. Job B is the same data under another sector id:
    64 stored nodes of each tree spot-checked against the host Poseidon,
    comm_r == H(comm_c, comm_r_last). Wall against twice phase 5's PC1 +
    PC2, peak host and device memory."""
    import hashlib

    import numpy as np
    import torch

    from crypto3_fil_proofs_torch.core.merkle import StoreConfig
    from crypto3_fil_proofs_torch.models.porep.stacked.vanilla.params import generate_replica_id
    from crypto3_fil_proofs_torch.ops.poseidon import hash2
    from crypto3_fil_proofs_torch.parallel.pipeline import SectorJob, seal_many
    from crypto3_fil_proofs_torch.parameters import public_params
    from crypto3_fil_proofs_torch.types import PoRepConfig

    config = PoRepConfig.for_sector_size(SECTOR_SIZE, POREP_ID)
    pp = public_params(config)
    nodes = SECTOR_SIZE // 32
    data = np.zeros((nodes, 32), dtype=np.uint8)
    staged = np.fromfile(run["staged"], dtype=np.uint8)
    data.reshape(-1)[: staged.shape[0]] = staged
    del staged
    comm_d = run["p2"].comm_d
    jobs = [SectorJob(sector_key=sid, data_leaves=data,
                      replica_id=generate_replica_id(PROVER_ID, sid, TICKET, comm_d, POREP_ID))
            for sid in (SECTOR_ID, SECTOR_ID + 1)]
    root = os.path.join(work, "seal_many")

    def configs_for(key):
        path = os.path.join(root, str(key))
        os.makedirs(path, exist_ok=True)
        return {"tree-d": StoreConfig(path, "tree-d"), "tree-c": [StoreConfig(path, "tree-c")],
                "tree-r-last": [StoreConfig(path, "tree-r-last")]}

    with HostPeak() as host:
        r = counted(lambda: seal_many(pp, jobs, shape=(8, 0, 0), workers=2, configs_for=configs_for))
    sealed = r.pop("out")
    a, b = sealed
    with open(os.path.join(run["cache"], "p_aux"), "rb") as f:
        paux = f.read()
    want = {"comm_d": comm_d, "comm_c": paux[:32], "comm_r_last": paux[32:64], "comm_r": run["p2"].comm_r,
            "replica": hashlib.sha256(np.fromfile(run["sealed"], dtype=np.uint8)).hexdigest()}
    got = {"comm_d": a.tau.comm_d, "comm_c": a.p_aux.comm_c, "comm_r_last": a.p_aux.comm_r_last,
           "comm_r": a.tau.comm_r, "replica": hashlib.sha256(a.replica).hexdigest()}
    if got != want:
        raise AssertionError(f"seal_many job A != phase 5: {first_difference(got, want)}")
    rng = random.Random(31)
    path_b = os.path.join(root, str(SECTOR_ID + 1))
    _check_tree_nodes(os.path.join(path_b, "sc-02-data-tree-r-last.dat"), nodes, 8, rng, 64)
    _check_tree_nodes(os.path.join(path_b, "sc-02-data-tree-c.dat"), nodes, 8, rng, 64)
    want_r = hash2(int.from_bytes(b.p_aux.comm_c, "little"), int.from_bytes(b.p_aux.comm_r_last, "little"))
    if want_r.to_bytes(32, "little") != b.tau.comm_r or b.tau.comm_r == a.tau.comm_r or b.tau.comm_d != comm_d:
        raise AssertionError("seal_many job B: comm_r != H(comm_c, comm_r_last), or equal to job A's")
    require("sm", r["launches"], SM_PATH)
    twice = 2 * (run["times"]["pc1_s"] + run["times"]["pc2_s"])
    log(f"phase 31: seal_many of 2 x {SECTOR_SIZE} B (2 labeling workers) on cuda in {r['wall_s']:.1f} s (traced) "
        f"against twice phase 5's PC1 + PC2, {twice:.1f} s: job A's comm_d, comm_c, comm_r_last, comm_r and replica "
        "== phase 5's; job B's 64 tree_r_last and 64 tree_c nodes == host Poseidon, comm_r == H(comm_c, "
        f"comm_r_last); peak host RSS {host.peak} B, device {r['peak_bytes']} B")
    log(f"  launches {json.dumps({k: v for k, v in r['launches'].items() if v})}")
    log_trace("seal_many", r["trace"])
    del sealed, a, b, data
    shutil.rmtree(root)
    return {"launches": r["launches"], "trace": r["trace"], "peak_bytes": r["peak_bytes"], "wall_s": r["wall_s"],
            "twice_pc_s": twice, "host_peak_bytes": host.peak}


def sharded_path(tree_ntt: dict, msm: dict) -> dict:
    """Path `sh`: the full-width sharded runs of phases 27 and 28."""
    path = merge_counted(*tree_ntt["path_runs"], *msm["path_runs"])
    require("sh", path["launches"], SH_PATH)
    log(f"  sh path launches {json.dumps({k: v for k, v in path['launches'].items() if v})}")
    return path


def phase_groth16_kernels(rows: list[dict], pre_run: dict, ntt_run: dict, curve_runs: dict,
                          msm_runs: dict, prove_run: dict, rates: dict, commit_run: dict,
                          post_runs: dict, batched: dict) -> list[dict]:
    """Rows of K1's Groth16 uses, K3-K6; every row's registers, its
    launches on each path and its device ms on each path (from the traced
    PC2, prove, commit path and PoSt paths; the LevelCache proofs are
    counted, not traced)."""
    from crypto3_fil_proofs_torch.ops import field as F

    # path: (launches, trace) of each run counted from 0
    paths = {"precommit_512MiB": (pre_run["launches"], pre_run["trace"]),
             "prove_2^19": (prove_run["launches"], prove_run["trace"]),
             "commit_512MiB": (commit_run["launches"], commit_run["trace"]),
             "phase2_512MiB": (commit_run["ceremony"]["launches"], commit_run["ceremony"]["trace"]),
             **{p: (r["launches"], r.get("trace")) for p, r in post_runs.items()}}
    entries = ptxas_entries()
    n = ntt_run["n"]
    mm_fr = montmul_mads(F.FR.n32)
    mm_fq = montmul_mads(F.FQ.n32)
    k1_row = rows[0]
    b_ms, b_by = bound_ms(3 * n * 32, n * mm_fr)
    k1_row["h_path"] = {"n": n, "ms": ntt_run["mul_ms"], "device_ms": ntt_run["mul_device_ms"],
                        "plain_ms": ntt_run["mul_plain_ms"], "max_abs_err": ntt_run["mul_err"],
                        "bound_ms": b_ms, "bound_by": b_by}
    tags = {"fr_montmul": ("montmul_kernel", "I2Fr"), "fq_montmul": ("montmul_kernel", "I2Fq"),
            "poseidon_a2": ("poseidon_kernel", "ILi3E"), "poseidon_a8": ("poseidon_kernel", "ILi9E"),
            "poseidon_a11": ("poseidon_kernel", "ILi12E")}
    for row in rows:
        row["registers"] = registers(entries, *tags[row["name"]])
    new = []
    b_ms, b_by = bound_ms(3 * n * 32, 0)
    new.append({
        "name": "fr_sub", "route": "cuda", "source": "crypto3_fil_proofs_torch/csrc/field.cu",
        "replaces": "crypto3_fil_proofs_tpu/ops/pallas/ntt.py:667",
        "n": n, "max_abs_err": ntt_run["sub_err"], "ms": ntt_run["sub_ms"],
        "device_ms": ntt_run["sub_device_ms"],
        "plain_ms": ntt_run["sub_plain_ms"], "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "registers": registers(entries, "fr_sub_kernel"),
    })
    log2n = n.bit_length() - 1
    k3_regs = {f"radix {1 << r}": {f"{which} pass": registers(entries, "ntt_pass_kernel", f"ILi{r}ELb{b}E")
                                   for which, b in (("first", 1), ("later", 0))} for r in (3, 2)}
    domains = {}
    for lg, d in sorted(ntt_run["domains"].items()):
        d_ms, d_by = bound_ms(2 * (32 << lg) + (32 << lg), ntt_products(lg) * mm_fr)
        domains[f"2^{lg}"] = {**d, "bound_ms": d_ms, "bound_by": d_by, "share": d_ms / d["ms"],
                              "device_share": d_ms / d["device_ms"] if d["device_ms"] else None,
                              "registers": k3_regs[f"radix {1 << d['radix_log']}"]}
    b_ms, b_by = bound_ms(2 * n * 32 + n * 32, ntt_products(log2n) * mm_fr)
    new.append({
        "name": "ntt", "route": "cuda", "source": "crypto3_fil_proofs_torch/csrc/ntt.cu",
        "replaces": "crypto3_fil_proofs_tpu/ops/pallas/ntt.py:264",
        "n": n, "max_abs_err": ntt_run["err"], "ms": ntt_run["ms"],
        "plain_ms": ntt_run["plain_ms"], "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "domains": domains, "h_pipeline_ms": ntt_run["h_ms"], "h_pipeline_peak_bytes": ntt_run["h_peak_bytes"],
        "registers": k3_regs,
        "last_pass_ms": {"from_l2": ntt_run["outer_pass_warm_ms"], "after_flush": ntt_run["outer_pass_cold_ms"]},
    })
    first = batched["shapes"][0]
    new.append({
        "name": "ntt_rows", "route": "cuda", "source": "crypto3_fil_proofs_torch/csrc/ntt_rows.cu",
        "replaces": "crypto3_fil_proofs_tpu/ops/pallas/ntt.py:264",
        "n": first["batch"] << first["log_n"], "max_abs_err": max(x["max_abs_err"] for x in batched["shapes"]),
        "ms": first["ms"], "plain_ms": first["plain_ms"], "plain_n": 1 << first["log_n"],
        "bound_ms": first["bound_ms"], "bound_by": first["bound_by"], "library_ms": None,
        "shapes": batched["shapes"], "registers": registers(entries, "ntt_rows_kernel"),
        "note": "K3b: the batched rows of the four-step NTT (ntt_sharded), each whole in one block; one launch a batch",
    })
    sites = {
        "g1": ("crypto3_fil_proofs_torch/csrc/g1.cu", "crypto3_fil_proofs_tpu/ops/pallas/g1.py",
               {"madd_nodbl": 533, "dbl": 559, "add": 580, "madd": 506}),
        "g2": ("crypto3_fil_proofs_torch/csrc/g2.cu", "crypto3_fil_proofs_tpu/ops/pallas/g2.py",
               {"madd_nodbl": 486, "dbl": 511, "add": 533}),
    }
    # each entry point's kernel, as ptxas names it
    ptx_names = {**{f"g1_{op}": (f"{op}_kernel", "I4fq_t") for op in ("madd_nodbl", "dbl", "add", "madd")},
                 **{f"g2_{op}": (f"pair_{op}_kernel",) for op in ("madd_nodbl", "dbl", "add")}}
    for g, (src, tpu, lines) in sites.items():
        run = curve_runs[g]
        k = 1 if g == "g1" else 2
        jac, aff = 3 * k * 48, 2 * k * 48
        io = {"madd_nodbl": jac + aff + 1 + jac + 1, "dbl": jac + 1 + jac, "add": 3 * jac,
              "madd": jac + aff + 1 + jac}
        for op in lines:
            lanes = run["n"]
            b_ms, b_by = bound_ms(lanes * io[op], lanes * CURVE_PRODUCTS[g][op] * mm_fq)
            new.append({
                "name": f"{g}_{op}", "route": "cuda", "source": src, "replaces": f"{tpu}:{lines[op]}",
                "n": lanes, "max_abs_err": run[f"{op}_err"],
                "ms": run[f"{op}_ms"], "plain_ms": run[f"{op}_plain_ms"], "plain_n": run["plain_n"],
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "registers": registers(entries, *ptx_names[f"{g}_{op}"]),
                **({"ms_readings": run[f"{op}_ms_readings"]} if f"{op}_ms_readings" in run else {}),
            })
    for g in ("g1", "g2"):
        run = msm_runs[g]
        prods = CURVE_PRODUCTS[g]
        # the work this run's data needs: one mixed add per nonzero digit,
        # two full adds per bucket to aggregate; points and scalars read once
        mads = (run["madds"] * prods["madd_nodbl"] + 2 * run["buckets"] * prods["add"]) * mm_fq
        nbytes = run["n"] * ((2 if g == "g1" else 4) * 48 + 32)
        b_ms, b_by = bound_ms(nbytes, mads)
        new.append({
            "name": f"msm_{g}", "route": "cuda", "source": "crypto3_fil_proofs_torch/csrc/msm.cu",
            "replaces": "crypto3_fil_proofs_tpu/ops/pallas/msm.py:206",
            "n": run["n"], "c": run["c"], "max_abs_err": run["err"], "ms": run["ms"],
            "plain_ms": run["plain_ms"], "plain_n": run["plain_n"], "ms_at_plain_n": run["ms_at_plain_n"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "registers": {k: registers(entries, f"{k}_kernel", "I4fq_t" if g == "g1" else "I5fq2_t")
                          for k in ("bucket_acc", "bucket_reduce", "agg_level")},
        })
    wr = post_runs["wr"]["shapes"]  # phase 32, arity 8 first
    path_batches = {"cm": commit_run["witness_batches"], "wn": post_runs["winning_post_512MiB"]["witness_batches"],
                    "wd": post_runs["window_post_512MiB"]["witness_batches"], "pm": post_runs["pm"]["witness_batches"]}
    held = set(WITNESS_SHAPES + WITNESS_PATH_SHAPES)
    missed = {(a, n) for rec in path_batches.values() for a, n, _ in rec} - held
    if missed:
        raise AssertionError(f"K7 ran batches {sorted(missed)} on the paths that phase 32 does not hold against "
                             "its plain version (WITNESS_PATH_SHAPES)")
    new.append({
        "name": "poseidon_witness", "route": "cuda",
        "source": "crypto3_fil_proofs_torch/csrc/poseidon_witness.cu",
        "replaces": "crypto3_fil_proofs_tpu/zk/gadgets/tiled.py:659",
        "n": wr[0]["n"], "arity": wr[0]["arity"], "max_abs_err": max(r["max_abs_err"] for r in wr),
        "ms": wr[0]["ms"], "kernel_ms": wr[0]["kernel_ms"], "plain_ms": wr[0]["plain_ms"], "plain_n": wr[0]["n"],
        "bound_ms": wr[0]["bound_ms"], "bound_by": wr[0]["bound_by"], "library_ms": None, "shapes": wr,
        "path_shapes": post_runs["wr"]["path_shapes"], "path_batches": path_batches,
        "registers": {f"{kernel} {a}": registers(entries, kernel, f"ILi{a + 1}E")
                      for kernel in ("witness_kernel", "witness_group_kernel") for a in (2, 8, 11)},
        "note": "the JAX package's XLA replay (_poseidon_witness_jax_fn), not a pallas_call; ms the wrapper's "
                "call, kernel_ms the kernel alone (CUDA events); the launcher picks the lane-group layout "
                "below a batch size per arity (switch), one thread per instance from there on",
    })
    for row in rows + new:  # launches and device ms by path
        name = row["name"]
        if name.startswith("msm_"):
            count = lambda d: {k: v for k, v in d.items() if k.startswith(name + "_")}
            row["launches_by_kernel"] = {p: count(d) for p, (d, _) in paths.items() if count(d)}
            row["launches_by_path"] = {p: sum(count(d).values()) for p, (d, _) in paths.items()}
        else:
            row["launches_by_path"] = {p: d.get(name, 0) for p, (d, _) in paths.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        row["path_ms"] = {p: path_ms(name, tr) for p, (_, tr) in paths.items()}
        if name in ("g1_madd_nodbl", "g2_madd_nodbl"):
            row["setup_fixed_base"] = commit_run["batches"][name[:2]]
        if name in ("g1_dbl", "g1_madd"):
            # the phase-2 rescale: every lane of l and h once per bit step
            # (dbl) or set bit (madd); the bound per lane and step is the
            # kernel's (io bytes, CURVE_PRODUCTS products)
            cer = commit_run["ceremony"]
            op = name[3:]
            io = {"dbl": 2 * 144 + 1, "madd": 144 + 96 + 1 + 144}  # G1 Jacobian in and out, affine q, mask
            lane_steps = cer["lanes"] * cer[f"{op}_steps"]
            b_ms, b_by = bound_ms(lane_steps * io[op], lane_steps * CURVE_PRODUCTS["g1"][op] * mm_fq)
            row["phase2"] = {"lanes": cer["lanes"], "steps": cer[f"{op}_steps"],
                             "launches": row["launches_by_path"]["phase2_512MiB"],
                             "device_ms": row["path_ms"]["phase2_512MiB"], "bound_ms": b_ms, "bound_by": b_by,
                             "bytes_per_lane_step": io[op], "products_per_lane_step": CURVE_PRODUCTS["g1"][op]}
    log(f"phase 12: mad32 rate measured {rates['mad32_per_s']:.4e}/s against the bound's {PEAK_MAD32_PER_S:.4e}/s")
    return rows + new


# ---------------------------------------------------------------------------
# Phase 32: the circuits' Poseidon witness replay (K7) at full width
# ---------------------------------------------------------------------------

# (arity, instances) of each replay: a 32 GiB Window PoSt partition's PoR
# level (2,349 sectors x 10 challenges, arity 8), its sector headers
# (arity 2), and a 32 GiB C2 partition's column hashes (18 challenges x
# 15 columns of 11 layers); kernel_times.py reads it
WITNESS_SHAPES = ((8, 2_349 * 10), (2, 2_349), (11, 18 * 15))
# (arity, instances) of the replays that C2 of the 512 MiB sector (2
# challenges: 6 DRG and 8 expander parent columns and the challenge's
# own, each hashed and proved in tree_c; the tree_r_last proofs), its
# Winning PoSt (66 x 1) and its Window PoSt (10 x 2, also each partition
# of prove_many) launch: the sector headers at arity 2, one call per
# PoR level at arity 8
WITNESS_PATH_SHAPES = ((2, 1), (2, 2), (2, 12), (2, 16), (8, 2), (8, 12), (8, 16), (8, 20), (8, 66))
REDC_MADS = 2 * _redc(8)  # one REDC against 1: a stored value into plain form
WITNESS_SEED = 32


def witness_bound(arity: int, n: int) -> tuple[float, str]:
    """K7's bound: the preimages read and the values written once, one
    permutation (K2's count) and one REDC per stored value."""
    from crypto3_fil_proofs_torch.ops import poseidon_torch as PT

    st, n_int = PT.staged(arity), PT.witness_len(arity)
    return bound_ms(n * (arity + n_int) * 32, n * (poseidon_mads(st.t, st.r_f, st.r_p) + n_int * REDC_MADS))


def phase_witness(seed: int) -> dict:
    """Phase 32 (path `wr`): zk/gadgets/tiled.py `poseidon_witness_v` on
    cuda (K1 into Montgomery form, K7, the copy back and the limb
    widening) of the golden's seeded batches ==
    tests/golden/torch_witness.json; then at WITNESS_SHAPES, counts from 0
    just before and read just after, each call's wall and peak device
    memory; every row of K7 == witness_plain on the card, each digest ==
    K2's, the entry point's arrays == K7's rows; K7's device time by CUDA
    events, the wrapper's call and the kernel alone; then the same at
    WITNESS_PATH_SHAPES. The path is not traced: its device time is the
    kernel's (kernel_times.py reads it too)."""
    import numpy as np
    import torch

    from crypto3_fil_proofs_torch.ops import field as F
    from crypto3_fil_proofs_torch.ops import poseidon_torch as PT
    from crypto3_fil_proofs_torch.ops.cuda import field as k1
    from crypto3_fil_proofs_torch.ops.cuda import poseidon as k2
    from crypto3_fil_proofs_torch.zk.gadgets import tiled

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_witness_ref as ref

    with open(ref.GOLDEN) as f:
        golden = json.load(f)["arities"]
    for arity in ref.ARITIES:
        got = tiled.poseidon_witness_v(ref.batch(arity), arity, device=DEVICE)
        if ref.digest(got) != golden[str(arity)]["sha256"]:
            raise AssertionError(f"K7 arity {arity}: the seeded batch's replay != the JAX package's "
                                 "(tests/golden/torch_witness.json)")
    log(f"phase 32: poseidon_witness_v on {DEVICE} of the seeded batches ({ref.K} instances at arities "
        f"{', '.join(map(str, ref.ARITIES))}) == the JAX package's XLA replay (tests/golden/torch_witness.json)")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    inputs = {a: rand_elems(F.FR, n * a, gen).cpu().numpy().view("<u2").astype(np.uint64).reshape(n, a, 16)
              for a, n in WITNESS_SHAPES}
    shapes, outs = [], {}
    torch_sync()
    # the main path: counts from 0 just before it, read just after it
    reset_counts()
    for arity, n in WITNESS_SHAPES:
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.time()
        outs[arity] = tiled.poseidon_witness_v(inputs[arity], arity, device=DEVICE)
        wall = time.time() - t0
        shapes.append({"arity": arity, "n": n, "n_int": PT.witness_len(arity), "wall_ms": 1e3 * wall,
                       "peak_bytes": torch.cuda.max_memory_allocated() - held})
    launches = all_counts()
    require("wr", launches, ["poseidon_witness", "fr_montmul"])
    switch = {a: k2.witness_switch(a) for a in k2.ARITIES}
    for row in shapes:
        arity, n = row["arity"], row["n"]
        pre = k1.to_mont(torch.from_numpy(inputs[arity].astype("<u2").view("<i4").reshape(-1, PT.L)).cuda())
        pre = pre.reshape(n, arity, PT.L)
        got = k2.witness(pre, arity)
        want, row["plain_ms"] = timed(lambda: PT.witness_plain(pre, arity))
        row["max_abs_err"] = check_equal(f"K7 arity {arity}", got.reshape(n, -1), want.reshape(n, -1))
        del want
        if not torch.equal(got[:, -1], k1.from_mont(k2.poseidon_hash(pre, arity))):
            raise AssertionError(f"K7 arity {arity}: digests != K2's")
        wit = torch.from_numpy(outs.pop(arity).astype("<u2").view("<i4"))
        if not torch.equal(wit, got.cpu()):
            raise AssertionError(f"poseidon_witness_v arity {arity}: its arrays != K7's rows")
        del wit, got
        witness_times(row, k2, pre, arity, switch[arity])
        del pre
        torch.cuda.empty_cache()
        log(f"phase 32: K7 arity {arity} on {n} instances ({row['n_int']} values each, {row['layout']}) == plain "
            f"on every row, digests == K2's; poseidon_witness_v wall {row['wall_ms']:.1f} ms (peak "
            f"{row['peak_bytes']} B), K7 {row['ms']:.4f} ms, {row['kernel_ms']:.4f} ms alone, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), plain {row['plain_ms']:.1f} ms")
    # the batch sizes of the paths: K7 == plain and its times at each
    path_shapes = []
    for arity, n in WITNESS_PATH_SHAPES:
        pre = rand_fr_mont(max(3, n * arity), gen)[: n * arity].reshape(n, arity, PT.L)
        row = {"arity": arity, "n": n, "n_int": PT.witness_len(arity)}
        got = k2.witness(pre, arity)
        want, row["plain_ms"] = timed(lambda: PT.witness_plain(pre, arity))
        row["max_abs_err"] = check_equal(f"K7 arity {arity} x {n}", got.reshape(n, -1), want.reshape(n, -1))
        if not torch.equal(got[:, -1], k1.from_mont(k2.poseidon_hash(pre, arity))):
            raise AssertionError(f"K7 arity {arity} x {n}: digests != K2's")
        witness_times(row, k2, pre, arity, switch[arity])
        path_shapes.append(row)
    log("phase 32: K7 == plain on every row, digests == K2's, at the paths' batch sizes; ms / alone / bound "
        + ", ".join(f"{r['arity']} x {r['n']} {r['ms']:.4f} / {r['kernel_ms']:.4f} / {r['bound_ms']:.5f}"
                    for r in path_shapes))
    log(f"  launches {json.dumps({k: v for k, v in launches.items() if v})}; lane groups below "
        f"{json.dumps(switch)} instances")
    return {"launches": launches, "trace": None, "shapes": shapes, "path_shapes": path_shapes, "switch": switch,
            "peak_bytes": max(r["peak_bytes"] for r in shapes)}


def witness_times(row: dict, k2, pre, arity: int, switch: int) -> None:
    """K7's device time at one shape by CUDA events into `row`: the
    wrapper's call, and the kernel alone into a buffer of the caller's
    layout (uncounted); its bound and the layout the launcher picks."""
    import torch

    n = pre.shape[0]
    row["ms"] = cuda_ms(lambda: k2.witness(pre, arity), 5)
    raw = torch.empty((n, row["n_int"], 8), dtype=torch.int32, device=pre.device)
    row["kernel_ms"] = cuda_ms(lambda: k2._launch("poseidon_witness", "poseidon_witness", pre, raw, arity), 5)
    row["bound_ms"], row["bound_by"] = witness_bound(arity, n)
    row["layout"] = "lane groups" if n < switch else "one thread"


class SideProcess:
    """Phases 17-19, 21-25 and 32 in a second process of this script, beside
    phases 14, 28, 20 and 15 of the first: they need only phases 4's and
    5's sectors, and most of both groups' work is single-threaded host
    Python, so the two overlap on the host's cores. The child reads the
    two sectors from `side_in.pkl` in the work directory, logs to
    `side.log` there, and writes its paths' launch counts and traces to
    `side_out.pkl`; each path's counts and trace are the child's own."""

    def __init__(self, work: str, run: dict, run_2k: dict):
        self.work = work
        self.log_path = os.path.join(work, "side.log")
        with open(os.path.join(work, "side_in.pkl"), "wb") as f:
            pickle.dump({"run": {k: run[k] for k in ("p2", "cache", "sealed")}, "run_2k": run_2k}, f)
        with open(self.log_path, "w") as out:
            self.proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--side", work], cwd=REPO,
                                         stdout=out, stderr=subprocess.STDOUT)
        self.shown = False

    def _show_log(self) -> None:
        if not self.shown and os.path.exists(self.log_path):
            with open(self.log_path) as f:
                sys.stdout.write(f.read())
            sys.stdout.flush()
        self.shown = True

    def join(self) -> dict:
        """Wait for the child, print its log, and return its results."""
        rc = self.proc.wait()
        self._show_log()
        if rc != 0:
            raise AssertionError(f"phases 17-19, 21-25, 32 (second process): exit code {rc}")
        with open(os.path.join(self.work, "side_out.pkl"), "rb") as f:
            return pickle.load(f)

    def stop(self) -> None:
        """Kill the child if it still runs (a failure of the first)."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._show_log()


def side_main(work: str) -> int:
    """The second process's phases (SideProcess): 17-19, 21-25 and 32, in
    the first process's order. Its marks are seconds since the epoch."""
    with open(os.path.join(work, "side_in.pkl"), "rb") as f:
        state = pickle.load(f)
    run, run_2k = state["run"], state["run_2k"]
    marks = {}
    post_runs = {"winning_post_512MiB": phase_post(work, run, "winning", 17)}
    phase_sector_challenges()
    post_runs["level_cache_512MiB"] = phase_level_cache(work, run)
    post_runs["window_post_512MiB"] = phase_post(work, run, "window", 18)
    marks["17-18 PoSt"] = time.time()
    phase_post_2k(work, run_2k)
    pc2k = phase_paramcache_2k(work, run_2k)
    phase_param_files(work, pc2k["cache"])
    marks["19, 21-22 2 KiB PoSt, lifecycle"] = time.time()
    post_runs["dg"] = phase_drg(work)
    post_runs["el"] = phase_election(work, run)
    phase_election_2k(work, run_2k)
    marks["23-25 legacy"] = time.time()
    post_runs["wr"] = phase_witness(WITNESS_SEED)
    marks["32 witness replay"] = time.time()
    with open(os.path.join(work, "side_out.pkl"), "wb") as f:
        pickle.dump({"post_runs": post_runs, "marks": marks}, f)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--side", metavar="WORK", help="run phases 17-19, 21-25 and 32 over the sectors that the first "
                    "process left in WORK (the script starts this process itself)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    record_witness_batches()
    if args.side:
        return side_main(args.side)
    t_start = time.time()
    marks = {}

    def mark(phases: str) -> None:
        marks[phases] = round(time.time() - t_start, 1)

    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    os.environ["FIL_PROOFS_PARENT_CACHE"] = os.path.join(work, "parents")
    # the host threads: the parent table beside the build, then the
    # unseal beside phases 6-14; the second process beside phases 14-15
    side = ThreadPoolExecutor(max_workers=1)
    second = None
    try:
        smi = smi_line()
        log(smi)
        disk = shutil.disk_usage(work)
        log(f"disk under {work}: {disk.free} B free of {disk.total} B; host: {os.cpu_count()} CPUs, "
            f"{torch.get_num_threads()} torch threads (the host products' pool, ops/fr_vec.py)")
        parents = side.submit(phase_parent_cache)
        phase_build()
        mark("1 build")
        rates = phase_rate_probe()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(args.seed)
        k1_runs = phase_k1(gen)
        k2_runs = phase_k2(gen)
        mark("2-3 K1, K2")
        run_2k = phase_2k(os.path.join(work, "2k"))
        mark("4 2 KiB pre-commit")
        log(f"phase 1: the 512 MiB graph's parent table made beside the build in {parents.result():.1f} s")
        run = phase_512(os.path.join(work, "main"), args.seed)
        mark("5 512 MiB pre-commit")
        unseal = side.submit(phase_unseal, work, run, args.seed)
        rows = phase_kernels(k1_runs, k2_runs, run["launches"])
        del k1_runs, k2_runs
        torch.cuda.empty_cache()
        ntt_run = phase_ntt(gen)
        curve_runs = phase_curves(args.seed)
        msm_runs = phase_msm(args.seed)
        mark("6-9 kernels")
        phase_mesh_golden()
        tree_ntt = phase_sharded_tree_ntt(run, gen)
        batched = phase_ntt_batched(gen)
        mark("26-27, 29 mesh, tree, NTT, K3b")
        phase_cubic()
        prove_run = phase_prove(args.seed)
        mark("10-11 cubic, 2^19 prove")
        c1_run = phase_commit1(run_2k, run)
        mark("13 C1, 2 KiB circuit")
        second = SideProcess(work, run, run_2k)
        commit_run = phase_commit(work, c1_run, args.seed)
        mark("14, 28, 20, 15 setup, sharded MSMs, ceremony, C2")
        shutil.rmtree(os.path.join(work, "params"))  # the 8.2 GB commit key
        side_out = second.join()
        post_runs = side_out["post_runs"]
        for phases, at in side_out["marks"].items():
            marks[phases + " (second process)"] = round(at - t_start, 1)
        mark("17-19, 21-25, 32 joined")
        post_runs["pm"] = phase_prove_many(work, run)
        mark("30 prove_many")
        unseal.result()
        mark("16 unseal joined")
        post_runs["sm"] = phase_seal_many(work, run)
        mark("31 seal_many")
        post_runs["sh"] = sharded_path(tree_ntt, commit_run["sharded_msm"])
        ntt_run["domains"][COMMIT_LOG_N] = {"ms": tree_ntt["k3_ms"], "device_ms": tree_ntt["k3_device_ms"],
                                            "passes": tree_ntt["k3_passes"], "radix_log": tree_ntt["k3_radix_log"]}
        rows = phase_groth16_kernels(rows, run, ntt_run, curve_runs, msm_runs, prove_run, rates, commit_run,
                                     post_runs, batched)
    finally:
        if second is not None:
            second.stop()
        side.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    log("phase timeline, s from the start at the end of each: " + json.dumps(marks))
    log(f"chip_smoke: every phase held in {time.time() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
