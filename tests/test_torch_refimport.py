"""gsearch_tpu_torch's import of reference-format databases
(index/refimport.py, the `import` subcommand) against gsearch_tpu's, on the
CPU, over the dumps tests/test_refimport.py writes.

Tolerances: none.  The readers are host numpy, so signatures, seqdicts,
parameters and layouts are equal, and a reader raises where gsearch_tpu's
raises; an imported database's files are byte-identical, and a graph
database imported by either package answers `request` with a byte-identical
neighbours file.  One deliberate difference is held port-only: a type name
in the graph description replaces parameters.json's dtype only when a
record layout of its size validates against the data file."""

import logging
import os
import struct

import numpy as np
import pytest
import torch

import gsearch_tpu.index.refimport as jref
import gsearch_tpu_torch.index.refimport as tref
from gsearch_tpu.cli.main import main as jax_main
from gsearch_tpu.core.params import (HnswParams, ProcessingParams,
                                     SeqSketcherParams)
from gsearch_tpu_torch.cli.main import main as torch_main
from gsearch_tpu_torch.core.params import ProcessingParams as TorchParams
from gsearch_tpu_torch.io.fasta import concat_file_codes
from gsearch_tpu_torch.models import make_sketcher
from test_refimport import _graph_description, _write_reference_dump

CPU = torch.device("cpu")


def _sigs(rng, dtype, n=37, dim=48):
    if dtype == np.float32:
        return rng.random((n, dim)).astype(np.float32)
    hi = {np.uint16: 1 << 16, np.uint32: 1 << 32, np.uint64: 1 << 62}[dtype]
    return rng.integers(0, hi, (n, dim), dtype=np.uint64).astype(dtype)


# (dtype, algo, kmer, writer options): every fixture shape of test_refimport.py
DUMPS = {
    "f32-magic-len": (np.float32, "OPTDENS", 16, dict(record_magic=True, record_len=True)),
    "f32-magic": (np.float32, "OPTDENS", 16, dict(record_magic=True, record_len=False)),
    "f32-len": (np.float32, "OPTDENS", 16, dict(record_magic=False, record_len=True)),
    "f32-bare": (np.float32, "OPTDENS", 16, dict(record_magic=False, record_len=False)),
    "f32-varint": (np.float32, "OPTDENS", 16, dict(len_kind="varint")),
    "f32-id-varint": (np.float32, "OPTDENS", 16, dict(record_magic=False, len_kind="varint")),
    "f32-u32-header": (np.float32, "OPTDENS", 16, dict(len_kind="u32", file_header=b"HNSWDUMP")),
    "f32-odd-header": (np.float32, "OPTDENS", 16,
                       dict(record_magic=False, file_header=b"\x01\x02\x03\x04\x05")),
    "u16-hll": (np.uint16, "HLL", 16, {}),
    "u32-prob": (np.uint32, "PROB3A", 16, {}),
    "u64-prob": (np.uint64, "PROB3A", 21, {}),
    "u64-super2": (np.uint64, "SUPER2", 21, dict(len_kind="varint")),
}


def _read_both(d, n, dim, dtype):
    path = os.path.join(d, "hnswdump.hnsw.data")
    got = []
    for mod in (jref, tref):
        try:
            got.append(mod.read_hnsw_data(path, n=n, dim=dim, dtype=dtype))
        except ValueError as e:
            got.append(e)
    return got


@pytest.mark.parametrize("name", list(DUMPS))
def test_readers_equal(tmp_path, name):
    dtype, algo, kmer, opts = DUMPS[name]
    rng = np.random.default_rng(len(name))
    dim = 96 if name == "f32-varint" else 48  # a 384-byte payload: the 0xFB + u16 varint
    sigs = _sigs(rng, dtype, dim=dim)
    d = str(tmp_path)
    _write_reference_dump(d, sigs, algo=algo, kmer=kmer, **opts)
    want, got = _read_both(d, 37, dim, dtype)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sigs)
    if dtype == np.uint64:
        folded = tref.fold_u64_sigs(got)
        assert folded.dtype == np.uint32
        np.testing.assert_array_equal(folded, jref.fold_u64_sigs(want))
    params = TorchParams.reload_json(d)
    assert tref.reference_sig_dtype(params) == jref.reference_sig_dtype(ProcessingParams.reload_json(d))
    graph = os.path.join(d, "hnswdump.hnsw.graph")
    assert tref.read_reference_description(graph) == jref.read_reference_description(graph)
    sd_path = os.path.join(d, "seqdict.json")
    want_sd, got_sd = jref.read_reference_seqdict(sd_path), tref.read_reference_seqdict(sd_path)
    assert [(i.id.path, i.id.fasta_id, i.len) for i in got_sd] == \
           [(i.id.path, i.id.fasta_id, i.len) for i in want_sd]
    assert len(got_sd) == 37


@pytest.mark.parametrize("fault", ["corrupted_ids", "truncated", "wrong_dim", "wrong_n"])
def test_readers_fail_alike(tmp_path, fault):
    """Corrupted ids and a truncated file raise the same error in both; a
    wrong dim or n gives the same outcome in both (a layout of the wrong
    size can still validate: 47-slot records read 4 bytes late)."""
    rng = np.random.default_rng(6)
    d = str(tmp_path)
    sigs = rng.random((37, 48)).astype(np.float32)
    _write_reference_dump(d, sigs, record_magic=True, record_len=True)
    path = os.path.join(d, "hnswdump.hnsw.data")
    data = bytearray(open(path, "rb").read())
    n, dim = 37, 48
    if fault == "corrupted_ids":
        stride = 4 + 8 + 8 + 48 * 4
        for i in range(37):
            data[i * stride + 4 : i * stride + 12] = struct.pack("<Q", 7_000_000 + i * 3)
    elif fault == "truncated":
        data = data[:-100]
    elif fault == "wrong_dim":
        dim = 47
    else:
        n = 36
    open(path, "wb").write(bytes(data))
    want, got = _read_both(d, n, dim, np.float32)
    if isinstance(want, ValueError):
        assert isinstance(got, ValueError) and str(got) == str(want)
    else:
        assert fault == "wrong_dim"
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("t_name", ["f32", "u16", "u32", "u64", "f64"])
@pytest.mark.parametrize("len_pack", ["u64", "u32", "u8"])
def test_description_reader(tmp_path, t_name, len_pack):
    p = tmp_path / "hnswdump.hnsw.graph"
    p.write_bytes(_graph_description(t_name, n=100, dim=48, len_pack=len_pack))
    assert tref.read_reference_description(str(p)) == jref.read_reference_description(str(p)) == t_name


def test_description_reader_garbage_and_array_seqdict(tmp_path):
    p = tmp_path / "hnswdump.hnsw.graph"
    p.write_bytes(b"\x00" * 128)
    assert tref.read_reference_description(str(p)) is None
    assert tref.read_reference_description(str(tmp_path / "missing")) is None
    sd = tmp_path / "seqdict.json"
    sd.write_text('[{"path": "a.fna", "fasta_id": "a", "len": 5},\n'
                  ' {"path": "b.fna", "fasta_id": "b", "len": 7}]')
    got = tref.read_reference_seqdict(str(sd))
    want = jref.read_reference_seqdict(str(sd))
    assert [(i.id.path, i.len) for i in got] == [(i.id.path, i.len) for i in want] == \
           [("a.fna", 5), ("b.fna", 7)]


def _import_both(ref, tmp_path, kind="auto"):
    outs = {}
    for pkg, run in (("jax", jref.import_reference_db), ("torch", tref.import_reference_db)):
        kw = {"device": CPU} if pkg == "torch" else {}
        outs[pkg] = (run(str(ref), str(tmp_path / f"out_{pkg}"), kind, **kw), tmp_path / f"out_{pkg}")
    return outs


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for f in names:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
    return names


@pytest.mark.parametrize("dtype,algo,kmer", [(np.float32, "OPTDENS", 16), (np.uint64, "PROB3A", 21),
                                             (np.uint16, "HLL", 16)])
def test_flat_import_files_identical(tmp_path, dtype, algo, kmer):
    """The imported flat database: the same summary and byte-identical files,
    which load in gsearch_tpu."""
    from gsearch_tpu.index.serialize import load_index

    rng = np.random.default_rng(2)
    ref = tmp_path / "refdb"
    ref.mkdir()
    sigs = _sigs(rng, dtype, n=200, dim=64)
    _write_reference_dump(str(ref), sigs, algo=algo, kmer=kmer)
    outs = _import_both(ref, tmp_path)
    (want, jdir), (got, tdir) = outs["jax"], outs["torch"]
    for key in want:
        assert got[key] == (want[key] if key != "out" else str(tdir)), key
    assert got["index_kind"] == "flat" and set(got["stages"]) == {"read", "build", "dump"}
    assert "index.sigs.npy" in _same_files(jdir, tdir)
    index = load_index(str(tdir))
    q = tref.fold_u64_sigs(sigs[:5]) if dtype == np.uint64 else sigs[:5]
    d, ids = index.search(q, knbn=1)
    assert (ids[:, 0] == np.arange(5)).all()


def test_description_type_accepted_only_when_it_validates(tmp_path, caplog):
    """u64 PROB3A signatures under a parameters.json claiming k = 16 (u32):
    both packages take the description's u64, whose layout validates.  A
    spurious length-prefixed "u64" in the header of an f32 dump: the port
    keeps parameters.json's f32 and logs it; gsearch_tpu takes u64 and
    cannot read the data."""
    rng = np.random.default_rng(8)
    ref = tmp_path / "refdb"
    ref.mkdir()
    sigs = rng.integers(0, 1 << 60, (64, 32), dtype=np.uint64)
    _write_reference_dump(str(ref), sigs, algo="PROB3A", kmer=16)
    outs = _import_both(ref, tmp_path)
    assert outs["jax"][0]["source_dtype"] == outs["torch"][0]["source_dtype"] == "uint64"
    _same_files(outs["jax"][1], outs["torch"][1])

    spurious = tmp_path / "spurious"
    spurious.mkdir()
    f32 = rng.random((64, 32)).astype(np.float32)
    _write_reference_dump(str(spurious), f32)
    (spurious / "hnswdump.hnsw.graph").write_bytes(_graph_description("u64", n=64, dim=32))
    assert tref.read_reference_description(str(spurious / "hnswdump.hnsw.graph")) == "u64"
    with pytest.raises(ValueError):
        jref.import_reference_db(str(spurious), str(tmp_path / "j_sp"))
    with caplog.at_level(logging.WARNING):
        res = tref.import_reference_db(str(spurious), str(tmp_path / "t_sp"), device=CPU)
    assert res["source_dtype"] == "float32"
    assert "keeping parameters.json's float32" in caplog.text
    (spurious / "hnswdump.hnsw.graph").write_bytes(_graph_description("f32", n=64, dim=32))
    jref.import_reference_db(str(spurious), str(tmp_path / "j_ok"))
    _same_files(tmp_path / "j_ok", tmp_path / "t_sp")
    assert not tref.ids_validate(str(spurious / "hnswdump.hnsw.data"), 64, 32, np.uint64)
    assert tref.ids_validate(str(spurious / "hnswdump.hnsw.data"), 64, 32, np.float32)


def test_cli_import_hnsw_then_request(tmp_path):
    """CLI `import --index hnsw` of a 2,048-row dump (8 genomes' signatures,
    the rest clustered decoys) by both packages, then `request` of the
    genomes themselves: byte-identical neighbours files, each query its own
    best hit at distance 0."""
    rng = np.random.default_rng(12)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genomes = tmp_path / "genomes"
    genomes.mkdir()
    for i in range(8):
        (genomes / f"g{i}.fna").write_bytes(b">g%d\n%s\n" % (i, acgt[rng.integers(0, 4, 15_000)].tobytes()))
    n, s = 2048, 256
    params = ProcessingParams(
        hnsw=HnswParams(capacity=1_500_000, ef=64, max_nb_conn=16, scale_modification=1.0),
        sketch=SeqSketcherParams(kmer_size=16, sketch_size=s, algo="OPTDENS", data_t="DNA"),
        block_flag=True)
    ref = tmp_path / "refdb"
    ref.mkdir()
    params.dump_json(str(ref))
    sketcher = make_sketcher(TorchParams.reload_json(str(ref)).sketch, device=CPU)
    real = sketcher.sketch_many([concat_file_codes(str(genomes / f"g{i}.fna"))[0] for i in range(8)])
    centers = rng.random((16, s)).astype(np.float32)
    decoys = centers[np.arange(n - 8) % 16].copy()
    redraw = rng.random(decoys.shape) < rng.uniform(0.05, 0.5, (n - 8, 1))
    decoys[redraw] = rng.random(int(redraw.sum())).astype(np.float32)
    _write_reference_dump(str(ref), np.concatenate([real, decoys]), kmer=16)
    params.dump_json(str(ref))  # the dump's own parameters: s = 256, M 16, ef 64
    with open(ref / "seqdict.json", "w") as f:
        for i in range(n):
            path = str(genomes / f"g{i}.fna") if i < 8 else f"decoys/d{i}.fna"
            f.write('{"id": {"path": "%s", "fasta_id": "g%d"}, "len": 15000}' % (path, i))
    outs = {}
    for pkg, run, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        db = str(tmp_path / f"db_{pkg}")
        assert run(["import", "-b", str(ref), "-o", db, "--index", "hnsw", *extra]) == 0
        out = str(tmp_path / f"req_{pkg}")
        assert run(["request", "-b", db, "-n", "5", "-r", str(genomes), "-o", out, *extra]) == 0
        outs[pkg] = (tmp_path / f"req_{pkg}" / "gsearch.neighbors.txt").read_text()
    assert outs["torch"] == outs["jax"]
    best = {}
    for line in outs["torch"].splitlines():
        if line.startswith("query_id:"):
            row = line.split("\t")  # query_id: q distance: d answer_fasta_path a ...
            best.setdefault(row[1], (row[5], row[3]))
    assert len(best) == 8 and all(best[q] == (q, "0.00000E0") for q in best)
