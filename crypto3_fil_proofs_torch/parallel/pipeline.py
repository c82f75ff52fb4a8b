"""Multi-sector sealing pipeline: host labeling beside device tree building.

Counterpart of crypto3_fil_proofs_tpu/parallel/pipeline.py (`SectorJob`,
`SealedSector`, `seal_many` :41; its `_transform` :77 is
`StackedDrg.replicate_labeled`, which the single-sector path shares),
the answer to the reference's multicore-SDR pipeline (SURVEY §2.9 P2,
configuration.hpp:60-65). SDR labeling is a sequential hash chain per layer, so it stays on
host cores, but different sectors are independent: a pool of workers
labels sectors at once (the native engine releases the GIL during its C
call) while the calling thread builds each labeled sector's trees and
commitments, the Poseidon work on `device` (kernels K1 and K2). The
parent table is made (or mapped from the parent cache) once, before the
pool starts. The commitments and replicas are those of the single-sector
path (`StackedDrg.transform_and_replicate_layers`).
"""
from __future__ import annotations

import concurrent.futures as _fut
from dataclasses import dataclass

import numpy as np

from ..api.seal import check_device
from ..core.settings import settings
from ..models.porep.stacked.vanilla.cache import ParentCache
from ..models.porep.stacked.vanilla.params import Labels
from ..models.porep.stacked.vanilla.proof import StackedDrg


@dataclass
class SectorJob:
    sector_key: object  # the caller's identity (e.g. (sector_id, cache_dir))
    replica_id: bytes
    data_leaves: np.ndarray  # (nodes, 32) uint8 padded sector data


@dataclass
class SealedSector:
    sector_key: object
    tau: object
    p_aux: object
    t_aux: object
    replica: np.ndarray


def seal_many(
    pp,
    jobs: list[SectorJob],
    shape=(8, 0, 0),
    workers: int | None = None,
    configs_for=None,
    device="cuda",
) -> list[SealedSector]:
    """Replicate many sectors, labeling beside tree building.

    `workers` labeling threads (default `multicore_sdr_producers`);
    `configs_for(sector_key) -> dict` may supply per-sector StoreConfigs
    ('tree-d' / 'tree-c' / 'tree-r-last') to keep the trees on disk.
    Results are returned in job order."""
    device = check_device(device)
    workers = workers or max(1, settings().multicore_sdr_producers)
    graph, layers = pp.graph, pp.layers
    parents = ParentCache(graph)  # made once: two workers must not build it twice

    def label(job: SectorJob) -> Labels:
        return StackedDrg.generate_labels(graph, layers, job.replica_id, parents)

    results: list[SealedSector | None] = [None] * len(jobs)
    with _fut.ThreadPoolExecutor(max_workers=workers) as pool:
        futures = {pool.submit(label, job): i for i, job in enumerate(jobs)}
        for fut in _fut.as_completed(futures):
            i = futures[fut]
            job = jobs[i]
            # the trees and commitments (on the device) in the calling thread
            cfg = configs_for(job.sector_key) if configs_for else None
            tau, p_aux, t_aux, replica = StackedDrg.replicate_labeled(job.data_leaves, fut.result(), shape, cfg,
                                                                      device)
            results[i] = SealedSector(job.sector_key, tau, p_aux, t_aux, replica)
    return results  # type: ignore[return-value]
