"""The port's multi-sector sealing pipeline (crypto3_fil_proofs_torch/
parallel/pipeline.py) and the in-memory replication it runs
(`StackedDrg.generate_labels`, `transform_and_replicate_layers`) on the
CPU, against the JAX package.

The jobs are tests/test_pipeline.py's: three 2 KiB sectors (ids 3, 4 and
9) of a 64-node graph with 2 layers. The JAX package's `seal_many` and
`transform_and_replicate_layers` of them run once per pytest run
(`shared_reference`); the port's, with device="cpu", must give the same
comm_d, comm_c, comm_r_last, comm_r and replica bytes. The tolerance is
exact equality throughout.
"""
import os

import numpy as np
import pytest
import torch

from crypto3_fil_proofs_tpu.core.fr32 import pad_sector
from crypto3_fil_proofs_tpu.core.settings import settings as jax_settings
from crypto3_fil_proofs_tpu.models.porep.stacked.vanilla import params as jax_params
from crypto3_fil_proofs_tpu.models.porep.stacked.vanilla.proof import StackedDrg as JaxStackedDrg
from crypto3_fil_proofs_tpu.parallel import pipeline as jax_pipeline
from crypto3_fil_proofs_torch.core.merkle import StoreConfig
from crypto3_fil_proofs_torch.core.settings import settings
from crypto3_fil_proofs_torch.models.porep.stacked.vanilla import params
from crypto3_fil_proofs_torch.models.porep.stacked.vanilla.proof import StackedDrg
from crypto3_fil_proofs_torch.parallel.pipeline import SectorJob, seal_many
from test_torch_setup import shared_reference

torch.set_num_threads(1)

SECTOR = 2048
NODES = SECTOR // 32
POREP_ID = bytes([1] * 32)
SECTOR_IDS = (3, 4, 9)


def _pp(pkg_params, setup):
    return setup(pkg_params.SetupParams(
        nodes=NODES, degree=6, expansion_degree=8, porep_id=POREP_ID,
        layer_challenges=pkg_params.LayerChallenges(layers=2, max_count=2),
    ))


def _jobs(job_cls, pkg_params):
    jobs = []
    for sector_id in SECTOR_IDS:
        data = bytes((i * 31 + sector_id) % 256 for i in range(2032))
        rid = pkg_params.generate_replica_id(bytes([9] * 32), sector_id, bytes([3] * 32), b"\0" * 32, POREP_ID)
        jobs.append(job_cls(sector_key=sector_id, replica_id=rid, data_leaves=pad_sector(data, SECTOR)))
    return jobs


def _summary(tau, p_aux, replica) -> dict:
    return {"comm_d": tau.comm_d, "comm_r": tau.comm_r, "comm_c": p_aux.comm_c,
            "comm_r_last": p_aux.comm_r_last, "replica": np.asarray(replica).tobytes()}


def _jax_reference(work) -> dict:
    saved = os.environ.get("FIL_PROOFS_PARENT_CACHE")
    os.environ["FIL_PROOFS_PARENT_CACHE"] = str(work / "parents")
    try:
        pp = _pp(jax_params, JaxStackedDrg.setup)
        jobs = _jobs(jax_pipeline.SectorJob, jax_params)
        sealed = jax_pipeline.seal_many(pp, jobs, shape=(8, 0, 0), workers=3)
        single = [JaxStackedDrg.transform_and_replicate_layers(pp, j.replica_id, j.data_leaves, shape=(8, 0, 0))
                  for j in jobs]
        return {"keys": [s.sector_key for s in sealed],
                "seal_many": [_summary(s.tau, s.p_aux, s.replica) for s in sealed],
                "single": [_summary(tau, p_aux, rep) for tau, p_aux, _, rep in single]}
    finally:
        if saved is None:
            del os.environ["FIL_PROOFS_PARENT_CACHE"]
        else:
            os.environ["FIL_PROOFS_PARENT_CACHE"] = saved


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return shared_reference(tmp_path_factory, "jax_seal_many_2k", _jax_reference)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    pp = _pp(params, StackedDrg.setup)
    return pp, _jobs(SectorJob, params)


def test_seal_many_equals_jax(jax_ref, port):
    pp, jobs = port
    sealed = seal_many(pp, jobs, shape=(8, 0, 0), workers=3, device="cpu")
    assert [s.sector_key for s in sealed] == jax_ref["keys"] == list(SECTOR_IDS)
    assert [_summary(s.tau, s.p_aux, s.replica) for s in sealed] == jax_ref["seal_many"] == jax_ref["single"]


def test_transform_and_replicate_layers_equals_jax(jax_ref, port):
    pp, jobs = port
    job = jobs[0]
    tau, p_aux, t_aux, replica = StackedDrg.transform_and_replicate_layers(
        pp, job.replica_id, job.data_leaves, shape=(8, 0, 0), device="cpu")
    assert _summary(tau, p_aux, replica) == jax_ref["single"][0]
    labels = StackedDrg.generate_labels(pp.graph, pp.layers, job.replica_id)
    assert [np.array_equal(a, b) for a, b in zip(labels.layers_data, t_aux.labels.layers_data)] == [True, True]
    assert t_aux.tree_r_last.root() == p_aux.comm_r_last and t_aux.tree_c.root() == p_aux.comm_c


def test_seal_many_keeps_trees_on_disk(jax_ref, port, tmp_path):
    """configs_for gives each sector's trees a store on disk."""
    pp, jobs = port

    def configs_for(key):
        path = str(tmp_path / str(key))
        os.makedirs(path)
        return {"tree-d": StoreConfig(path, "tree-d"), "tree-c": [StoreConfig(path, "tree-c")],
                "tree-r-last": [StoreConfig(path, "tree-r-last")]}

    sealed = seal_many(pp, jobs[:2], workers=2, configs_for=configs_for, device="cpu")
    assert [_summary(s.tau, s.p_aux, s.replica) for s in sealed] == jax_ref["seal_many"][:2]
    assert sorted(os.listdir(tmp_path / "3")) == sorted(os.listdir(tmp_path / "4"))
    assert len(os.listdir(tmp_path / "3")) >= 3


def test_multicore_sdr_settings_equal_jax(monkeypatch):
    assert settings().multicore_sdr_producers == jax_settings().multicore_sdr_producers
    monkeypatch.setenv("FIL_PROOFS_MULTICORE_SDR_PRODUCERS", "2")
    assert settings().multicore_sdr_producers == 2


def test_seal_many_raises_without_cuda(port, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pp, jobs = port
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        seal_many(pp, jobs)
