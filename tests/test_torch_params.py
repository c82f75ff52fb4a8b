"""The port's parameter lifecycle on the CPU against the JAX package,
with exact equality: the query rescaling (ops/g1_scale.py, the plain
version), the phase-2 ceremony on the cubic key (cli/phase2.py), the
paramcache requests (cli/paramcache.py), the parameter-file digests and
map (param.py), fakeipfsadd's CIDs and the publish / fetch round trip
(cli/parampublish.py, cli/paramfetch.py) with fakeipfsadd as the `ipfs`
binary and a content-addressed stand-in for `ipget`; nothing touches a
network.

The cubic key is the JAX package's (tests/test_torch_groth16.py
`shared_jax_cubic`, computed once per run); no test here runs a setup or
a prove.
"""
import json
import os
import random
import shutil
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from crypto3_fil_proofs_torch import param as port_param
from crypto3_fil_proofs_torch.cli import fakeipfsadd as port_fake
from crypto3_fil_proofs_torch.cli import paramcache as port_paramcache
from crypto3_fil_proofs_torch.cli import paramfetch as port_fetch
from crypto3_fil_proofs_torch.cli import parampublish as port_publish
from crypto3_fil_proofs_torch.cli import phase2 as port_phase2
from crypto3_fil_proofs_torch.core import parameter_cache as port_cache
from crypto3_fil_proofs_torch.core.compound import CompoundProof as PortCompound
from crypto3_fil_proofs_torch.ops import field as F
from crypto3_fil_proofs_torch.ops.bls12_381 import G1_GEN, G1_INF, R, g1_from_affine, g1_mul
from crypto3_fil_proofs_torch.ops.g1_scale import scale_g1
from test_torch_groth16 import shared_jax_cubic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A private parameter cache that both packages read."""
    from crypto3_fil_proofs_tpu.core.settings import reset_settings

    d = tmp_path / "cache"
    d.mkdir()
    monkeypatch.setenv("FIL_PROOFS_PARAMETER_CACHE", str(d))
    reset_settings()
    yield d
    reset_settings()


def _arrays(path) -> dict:
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def _seeded_points(n: int, seed: int):
    rng = random.Random(seed)
    g = g1_from_affine(G1_GEN)
    pts = [g1_mul(g, rng.randrange(1, R)) for _ in range(n)]
    for i in (0, n // 3, n - 1):  # infinity lanes, first and last among them
        pts[i] = G1_INF
    return pts


@pytest.mark.parametrize("k", [1, R - 1], ids=["k=1", "k=r-1"])
def test_scale_g1_plain_equals_jax(k):
    """64 seeded points with infinity lanes: scale_g1's plain version ==
    cli/phase2.py `_batch_scale_g1_query`, limb for limb."""
    from crypto3_fil_proofs_tpu.cli.phase2 import _batch_scale_g1_query
    from crypto3_fil_proofs_tpu.zk.groth16 import _stage_g1

    px, py, valid = _stage_g1(_seeded_points(64, 7))
    want = _batch_scale_g1_query((px, py, valid), k)
    got, ok = scale_g1(F.from_jax_limbs(px), F.from_jax_limbs(py), torch.from_numpy(np.array(valid)), k,
                       device="cpu")
    assert np.array_equal(F.to_jax_limbs(got[:, 0]), want[0])
    assert np.array_equal(F.to_jax_limbs(got[:, 1]), want[1])
    assert np.array_equal(ok.numpy(), np.asarray(want[2]))


def test_scale_g1_zero_scalar_gives_infinity():
    pts, valid = port_phase2.G1.points_to_device(_seeded_points(8, 3))
    got, ok = scale_g1(pts[:, 0], pts[:, 1], valid, R, device="cpu")
    assert not ok.any() and not got.any()


@pytest.fixture(scope="module")
def ceremony(tmp_path_factory):
    """The cubic key written by the JAX package, and each package's
    contribution to it with --seed alice."""
    from crypto3_fil_proofs_tpu.cli import phase2 as jax_phase2
    from crypto3_fil_proofs_tpu.core.parameter_cache import _save_pk as jax_save_pk

    ref = shared_jax_cubic(tmp_path_factory)
    d = tmp_path_factory.mktemp("ceremony")
    p0 = str(d / "cubic_0")
    jax_save_pk(p0, ref["pk"])
    jax_p1, port_p1 = str(d / "jax_1"), str(d / "cubic_1")
    assert jax_phase2.main(["contribute", p0, "--seed", "alice", "--out", jax_p1]) == 0
    assert port_phase2.main(["contribute", p0, "--seed", "alice", "--device", "cpu"]) == 0
    return SimpleNamespace(dir=d, p0=p0, jax_p1=jax_p1, port_p1=port_p1)


def test_contribute_equals_jax(ceremony):
    want, got = _arrays(ceremony.jax_p1), _arrays(ceremony.port_p1)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    old = _arrays(ceremony.p0)
    assert not np.array_equal(got["h_query_x"], old["h_query_x"])
    assert np.array_equal(got["a_query_x"], old["a_query_x"])


def _tampered(ceremony, name: str, edit) -> str:
    arrays = _arrays(ceremony.port_p1)
    edit(arrays)
    path = str(ceremony.dir / name)
    np.savez(path + ".npz", **arrays)
    os.replace(path + ".npz", path)
    return path


@pytest.mark.parametrize("tamper", [None, "delta_g2", "h_query"])
def test_each_verify_accepts_the_others_contribution(ceremony, tamper):
    """Each package's verify accepts the other's contribution and refuses
    one whose delta_g2 is left unscaled or whose h_query lane is not."""
    from crypto3_fil_proofs_tpu.cli import phase2 as jax_phase2

    old = _arrays(ceremony.p0)
    if tamper is None:
        port_new, jax_new = ceremony.jax_p1, ceremony.port_p1
    elif tamper == "delta_g2":
        port_new = jax_new = _tampered(ceremony, "bad_delta", lambda a: a.update(vk_delta=old["vk_delta"]))
    else:
        def edit(a):
            a["h_query_x"][0], a["h_query_y"][0] = old["h_query_x"][0], old["h_query_y"][0]

        port_new = jax_new = _tampered(ceremony, "bad_h", edit)
    want = 0 if tamper is None else 1
    assert port_phase2.main(["verify", ceremony.p0, port_new]) == want
    assert jax_phase2.main(["verify", ceremony.p0, jax_new]) == want


def test_small_merge_split_convert_verifyd(ceremony, cache, capsys):
    """The JAX package's tests/test_cli.py flow on the port's
    contribution: small (its json equal to the JAX package's), merge
    against the original (and a tampered small file refused), split-keys
    into the cache, convert both ways, and verifyd over a chain whose
    second link the JAX package contributed."""
    from crypto3_fil_proofs_tpu.cli import phase2 as jax_phase2

    d, p0, p1 = ceremony.dir, ceremony.p0, ceremony.port_p1
    small, jax_small = str(d / "small.json"), str(d / "jax_small.json")
    assert port_phase2.main(["small", p1, "--out", small]) == 0
    assert jax_phase2.main(["small", p1, "--out", jax_small]) == 0
    with open(small) as f, open(jax_small) as g:
        assert json.load(f) == json.load(g)
    assert port_phase2.main(["merge", small, p1, "--original", p0]) == 0
    assert os.path.exists(p1 + ".meta")
    with open(small) as f:
        data = json.load(f)
    data["delta_g1"] = "00" + data["delta_g1"][2:]
    bad = str(d / "bad_small.json")
    with open(bad, "w") as f:
        json.dump(data, f)
    assert port_phase2.main(["merge", bad, p1]) == 1

    assert port_phase2.main(["split-keys", p1, "--prefix", "test-circuit-cubic"]) == 0
    split = _arrays(port_cache.params_path("test-circuit-cubic"))
    for k, v in _arrays(p1).items():
        assert np.array_equal(split[k], v), k
    assert _arrays(port_cache.vk_path("test-circuit-cubic"))["vk_delta"].tobytes() == split["vk_delta"].tobytes()
    with open(port_cache.meta_path("test-circuit-cubic")) as f:
        assert json.load(f)["query_digest"] == data["query_digest"]

    raw, comp = str(d / "cubic_raw"), str(d / "cubic_comp")
    assert port_phase2.main(["convert", p1, "--to", "compressed", "--out", comp]) == 0
    assert port_phase2.main(["convert", comp, "--to", "raw", "--out", raw]) == 0
    for k, v in _arrays(p1).items():
        assert np.array_equal(_arrays(raw)[k], v), k

    p2 = str(d / "cubic_2")
    assert jax_phase2.main(["contribute", p1, "--seed", "carol", "--out", p2]) == 0
    capsys.readouterr()
    assert port_phase2.main(["verifyd", p0, "--sleep", "0.01", "--rounds", "2"]) == 0
    assert capsys.readouterr().out.count("verified transition") == 2


def _recorder(log: list):
    def get_params(self, pub_params, seed=None, device="cuda"):
        pp = pub_params
        ident = pp.identifier() if hasattr(pp, "identifier") else (
            pp.sector_size, pp.challenge_count, pp.sector_count)
        log.append((self.adapter.cache_prefix(pp), ident))
        return SimpleNamespace(log_n=0)

    return get_params


@pytest.mark.parametrize("argv", [["--params-for-sector-sizes", "2048,536870912"],
                                  ["--params-for-sector-sizes", "2048", "--only-post"]])
def test_paramcache_requests_equal_jax(monkeypatch, argv):
    """With get_params replaced by a recorder: the cache prefixes and
    public params paramcache asks for == the JAX package's."""
    from crypto3_fil_proofs_tpu.cli import paramcache as jax_paramcache
    from crypto3_fil_proofs_tpu.core.compound import CompoundProof as JaxCompound

    got, want = [], []
    monkeypatch.setattr(PortCompound, "get_params", _recorder(got))
    monkeypatch.setattr(JaxCompound, "get_params", _recorder(want))
    assert port_paramcache.main(argv + ["--device", "cpu"]) == 0
    assert jax_paramcache.main(argv) == 0
    assert got == want and len(got) == (2 if "--only-post" in argv else 6)


def test_paramcache_refuses_unsupported_size(monkeypatch):
    monkeypatch.setattr(PortCompound, "get_params", _recorder([]))
    assert port_paramcache.main(["--params-for-sector-sizes", "1234", "--device", "cpu"]) == 1


def test_param_digests_and_map_equal_jax(cache, tmp_path):
    from crypto3_fil_proofs_tpu import param as jax_param

    rng = np.random.default_rng(5)
    for name, size in (("v28-aaaa.params", 3 << 20), ("v28-aaaa.vk", 1000), ("v28-aaaa.meta", 10),
                       ("other.txt", 5)):
        (cache / name).write_bytes(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    files = port_param.cached_parameter_files()
    assert files == jax_param.cached_parameter_files() == ["v28-aaaa.meta", "v28-aaaa.params", "v28-aaaa.vk"]
    digests = {f: port_param.get_digest_for_file_within_cache(f) for f in files}
    assert digests == {f: jax_param.get_digest_for_file_within_cache(f) for f in files}
    assert port_param.parameter_id("v28-aaaa.params") == "v28-aaaa"
    assert port_param.add_extension("v28-aaaa", "vk") == "v28-aaaa.vk"
    assert port_param.has_extension("v28-aaaa.vk", "vk") and not port_param.has_extension("v28-aaaa.vk", "params")

    m = {f: port_param.ParameterData(cid=f"Qm{i}", digest=digests[f], sector_size=2048 * i)
         for i, f in enumerate(files)}
    port_path, jax_path = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    port_param.write_parameter_map(port_path, m)
    jax_param.write_parameter_map(jax_path, {k: jax_param.ParameterData(**vars(v)) for k, v in m.items()})
    with open(port_path, "rb") as f, open(jax_path, "rb") as g:
        assert f.read() == g.read()
    assert port_param.read_parameter_map(jax_path) == m
    assert {k: vars(v) for k, v in jax_param.read_parameter_map(port_path).items()} == {
        k: vars(v) for k, v in m.items()}


def test_fakeipfsadd_cid_equals_jax(tmp_path, monkeypatch, capsys):
    from crypto3_fil_proofs_tpu.cli import fakeipfsadd as jax_fake

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    p = tmp_path / "f.bin"
    p.write_bytes(b"hello parameters")
    assert port_fake.main(["add", "-Q", str(p)]) == 0
    cid = capsys.readouterr().out.strip()
    assert cid == jax_fake.fake_cid(str(p)) == port_fake.fake_cid(str(p)) and cid.startswith("Qmfake")


def _stand_ins(tmp_path) -> tuple[str, str]:
    """`ipfs` (fakeipfsadd, which keeps a copy of each added file under
    $TMPDIR/fakeipfs-*) and an `ipget` that serves those copies by CID."""
    ipfs, ipget = tmp_path / "ipfs", tmp_path / "ipget"
    ipfs.write_text(f"#!/bin/sh\nPYTHONPATH={REPO} exec {sys.executable} -m "
                    "crypto3_fil_proofs_torch.cli.fakeipfsadd \"$@\"\n")
    ipget.write_text(
        f"#!{sys.executable}\n"
        "import glob, os, shutil, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from crypto3_fil_proofs_torch.cli.fakeipfsadd import fake_cid\n"
        "out, cid = sys.argv[2], sys.argv[3]\n"
        "for p in glob.glob(os.path.join(os.environ['TMPDIR'], 'fakeipfs-*', '*')):\n"
        "    if fake_cid(p) == cid:\n"
        "        shutil.copy(p, out)\n"
        "        sys.exit(0)\n"
        "sys.exit(1)\n")
    for p in (ipfs, ipget):
        p.chmod(0o755)
    return str(ipfs), str(ipget)


def test_publish_fetch_roundtrip(cache, tmp_path, monkeypatch):
    """parampublish with fakeipfsadd as `ipfs` writes the manifest;
    paramfetch fills an empty cache from it with equal digests, refetches
    a corrupted cached file, and refuses a file whose digest disagrees
    with the manifest."""
    store = tmp_path / "store"
    store.mkdir()
    monkeypatch.setenv("TMPDIR", str(store))
    ipfs, ipget = _stand_ins(tmp_path)
    rng = np.random.default_rng(9)
    for name in ("v28-aaaa.params", "v28-aaaa.vk", "v28-bbbb.vk"):
        (cache / name).write_bytes(rng.integers(0, 256, 4096, dtype=np.uint8).tobytes())
    manifest = str(tmp_path / "parameters.json")
    assert port_publish.main(["--json", manifest, "--ipfs-bin", ipfs]) == 0
    data = port_param.read_parameter_map(manifest)
    assert sorted(data) == ["v28-aaaa.params", "v28-aaaa.vk"]  # v28-bbbb has no .params
    assert all(v.cid == port_fake.fake_cid(str(cache / k)) for k, v in data.items())
    digests = {k: port_param.get_digest_for_file_within_cache(k) for k in data}
    assert {k: v.digest for k, v in data.items()} == digests

    second = tmp_path / "second"
    second.mkdir()
    monkeypatch.setenv("FIL_PROOFS_PARAMETER_CACHE", str(second))
    assert port_fetch.main(["--json", manifest, "--all", "--ipget-bin", ipget]) == 0
    assert sorted(os.listdir(second)) == sorted(data)
    assert {k: port_param.get_digest_for_file_within_cache(k) for k in data} == digests

    (second / "v28-aaaa.params").write_bytes(b"corrupted")
    assert port_fetch.main(["--json", manifest, "--all", "--ipget-bin", ipget]) == 0
    assert port_param.get_digest_for_file_within_cache("v28-aaaa.params") == digests["v28-aaaa.params"]

    data["v28-aaaa.vk"].digest = "0" * 32
    port_param.write_parameter_map(manifest, data)
    os.remove(second / "v28-aaaa.vk")
    assert port_fetch.main(["--json", manifest, "--all", "--ipget-bin", ipget, "--retry", "1"]) == 1
    assert not (second / "v28-aaaa.vk").exists()
    shutil.rmtree(store)
