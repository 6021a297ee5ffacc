"""Scale-out: sharded sketching and sharded search over a mesh of torch devices.

Counterpart of gsearch_tpu/parallel/mesh.py, which makes the reference's
offline N-piece scripts (split the genome directory, build N indexes,
search each, merge by hand) first-class:

* a mesh is an ordered list of members on axis 'd', or laid out ('d', 's')
  (row shards x sketch-slot halves); a member is a torch device, and one
  device may hold several members (they run one after another there:
  correct, and no faster than one member);
* the database [N, S] is row-sharded, member g holding one contiguous
  shard (the analog of one bash "piece"); queries go to every member;
* each member computes its local top-k with the port's kernels (K1 for the
  exact sweep; the int8 product and K2 `parts=2` for the compact searcher;
  the beam and K2 `parts=1` for the graph), and the members' [Q, k] lists
  are concatenated in member order and merged by one stable top-k on the
  host, the reference's all_gather + lax.top_k;
* across processes (`initialize_multihost`) only those lists cross, as
  host tensors through torch.distributed's gloo backend, laid out in
  global member order (rank-major).  NCCL would refuse two ranks on one
  card, and the lists are a few KB a query;
* sketching is data-parallel: `SketcherBase.set_mesh` splits each launch
  group's rows over this process's members.

Tie order: contiguous row shards merged in member order return (distance,
id) order, as one index does; the graph's round-robin shards return shard
order (index/sharded.py), as the reference's merge does.
"""

from __future__ import annotations

import math
import os
import tempfile
from typing import List, Sequence

import numpy as np
import torch

from ..ops.distance import _as_i32, _distance, as_int32_rows, gather_hamming, hamming_frac, topk_smallest
from ..ops.mxu import MxuSearcher, _next_pow2, _round_up
from ..utils import get_logger

log = get_logger(__name__)

#: rows of the compact searcher's shards are padded to a multiple of this
#: (the reference's chunked, shard-aligned upload)
MXU_SHARD_ROWS = 1024


def initialize_multihost(coordinator: str | None = None, num_processes: int | None = None,
                         process_id: int | None = None) -> int:
    """Join this process to a group of cooperating processes, one call per
    process before a mesh is made: torch.distributed's gloo backend over a
    TCP rendezvous at `coordinator` ("host:port"; default
    MASTER_ADDR:MASTER_PORT), with WORLD_SIZE and RANK as the defaults of
    the other two.  A mesh made afterwards spans every process's members,
    rank-major.  Returns this process's rank; the caller ends the group
    with torch.distributed.destroy_process_group()."""
    import torch.distributed as dist

    env = os.environ
    if coordinator is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("no coordinator given and MASTER_ADDR / MASTER_PORT unset")
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = int(env["WORLD_SIZE"] if num_processes is None else num_processes)
    rank = int(env["RANK"] if process_id is None else process_id)
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}", world_size=world, rank=rank)
    log.info("multihost: process %d of %d (gloo at %s)", rank, world, coordinator)
    return rank


class DeviceMesh:
    """Global members 0..size-1 on axis 'd' (shape (D,)) or laid out
    ('d', 's') row-major (shape (D/2, 2): member g at (g // 2, g % 2)).
    `devices` are this process's members, global members rank * len(devices)
    onwards."""

    def __init__(self, devices: Sequence[torch.device], shape: tuple, axis_names: tuple,
                 rank: int = 0, world_size: int = 1):
        self.devices = tuple(torch.device(d) for d in devices)
        self.shape = tuple(shape)
        self.axis_names = tuple(axis_names)
        self.rank, self.world_size = int(rank), int(world_size)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def members(self) -> list:
        """(global member index, device) of each of this process's members."""
        first = self.rank * len(self.devices)
        return [(first + j, dev) for j, dev in enumerate(self.devices)]

    def gather(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This process's parts (equal shapes, the same count in every
        process) and every other process's, as host tensors in rank order,
        which is global member order."""
        parts = [p.cpu() for p in parts]
        if self.world_size == 1:
            return parts
        import torch.distributed as dist

        mine = torch.stack(parts)
        every = [torch.empty_like(mine) for _ in range(self.world_size)]
        dist.all_gather(every, mine)
        return [p for block in every for p in block]


def make_device_mesh(n_devices: int | None = None, two_d: bool = False, *, device,
                     devices: Sequence | None = None) -> DeviceMesh:
    """A mesh of this process's first n members (None or -1: all of them)
    times every process of `initialize_multihost`'s group, rank-major.

    Members: `devices` when given (a device may repeat); else on CUDA the
    cards cuda:0..n-1, where asking for more than torch.cuda.device_count()
    raises ValueError naming both counts; else (the CPU) n members on the
    one CPU device (all: one).  2-D ('d', 's') when `two_d` is set and the
    global count is even and at least 4, else 1-D ('d',); a 2-D mesh keeps
    each 's' pair in one process."""
    device = torch.device(device)
    want = None if n_devices in (None, -1) else int(n_devices)
    if want is not None and want < 1:
        raise ValueError(f"a mesh needs at least one member, not {n_devices}")
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if want is not None and want > len(devs):
            raise ValueError(f"a mesh of {want} members asks for more than the {len(devs)} devices given")
        devs = devs[:want]
    elif device.type == "cuda":
        count = torch.cuda.device_count()
        n = count if want is None else want
        if n > count or n == 0:
            raise ValueError(f"a mesh of {n} members needs {n} CUDA cards, but {count} are visible")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [device] * (want or 1)
    rank, world = 0, 1
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    total = len(devs) * world
    if two_d and total % 2 == 0 and total >= 4:
        if len(devs) % 2:
            raise ValueError(f"a 2-D mesh keeps each 's' pair in one process: {len(devs)} local members")
        return DeviceMesh(devs, (total // 2, 2), ("d", "s"), rank, world)
    return DeviceMesh(devs, (total,), ("d",), rank, world)


def _bits(x) -> torch.Tensor:
    """Signature rows as int32 bit patterns: host numpy of any signature
    type (u16 widened by value), or a tensor on any device."""
    if isinstance(x, np.ndarray):
        return as_int32_rows(x)
    return _as_i32(x, "mesh")


def _rows(sigs, start: int, stop: int, cols: slice, device: torch.device) -> torch.Tensor:
    """Rows [start, stop) of sigs as int32 bits on `device`, those past the
    end zero (pad rows); only the rows inside sigs are read."""
    n, s = sigs.shape
    width = len(range(s)[cols])
    live = sigs[min(start, n) : min(stop, n), cols]
    part = _bits(live).to(device) if live.shape[0] else torch.empty((0, width), dtype=torch.int32,
                                                                     device=device)
    if part.shape[0] < stop - start:
        pad = torch.zeros((stop - start - part.shape[0], width), dtype=torch.int32, device=device)
        part = torch.cat([part, pad])
    return part.contiguous()


def _col_slices(mesh: DeviceMesh, s: int) -> list:
    if "s" not in mesh.axis_names:
        return [slice(0, s)]
    h = (s + 1) // 2
    return [slice(0, h), slice(h, s)]


def shard_database(db, mesh: DeviceMesh, n_rows: int | None = None) -> List[torch.Tensor]:
    """This process's members' shards of a [N, S] signature matrix (host
    numpy of any signature type, a numpy memmap, or a tensor), as int32
    bits on each member's device: rows split contiguously over 'd' into
    shards of n_rows / D rows (n_rows >= N, a multiple of the row shards,
    default N; rows past N are zero) and, on a 2-D mesh, slots in halves
    over 's'.  Rows of other processes' members are never read."""
    n, s = db.shape
    n_rows = n if n_rows is None else int(n_rows)
    row_shards = mesh.shape[0]
    if n_rows < n or n_rows % row_shards:
        raise ValueError(f"{n_rows} rows do not split over {row_shards} row shards (N = {n})")
    nl, cols = n_rows // row_shards, _col_slices(mesh, s)
    out = []
    for g, dev in mesh.members():
        r, c = (g // 2, cols[g % 2]) if len(cols) == 2 else (g, cols[0])
        out.append(_rows(db, r * nl, (r + 1) * nl, c, dev))
    return out


def equal_counts(d: torch.Tensor, s: int) -> torch.Tensor:
    """K1's distances (1 - eq/s in f32) back to the int32 equal-slot counts
    eq: exact while s < 2^22 (f32 keeps eq/s to 2^-24)."""
    return torch.round((1.0 - d.to(torch.float64)) * s).to(torch.int32)


def _local_topk(d: torch.Tensor, row0: int, n_live: int, k: int):
    """A member's k nearest of its rows, row0 its first global row: rows
    at or past n_live are +inf; global ids int32."""
    if row0 + d.shape[1] > n_live:
        lids = torch.arange(row0, row0 + d.shape[1], device=d.device)
        d = torch.where((lids < n_live)[None, :], d, torch.inf)
    vals, idx = topk_smallest(d, min(k, d.shape[1]))
    return vals, (idx + row0).to(torch.int32)


def _merge(mesh: DeviceMesh, dists: list, ids: list, k: int):
    """This process's and every other process's [Q, k_local] lists,
    concatenated in global member order; the k smallest by a stable sort
    (ties: the earlier member).  Host tensors."""
    d = torch.cat(mesh.gather(dists), 1)
    g = torch.cat(mesh.gather(ids), 1)
    vals, sel = topk_smallest(d, min(k, d.shape[1]))
    return vals, g.gather(1, sel)


def sharded_knn(mesh: DeviceMesh, s_total: int, knbn: int):
    """The sharded exact search step: (db_shards, q, n_live) -> (d [Q, k]
    f32, ids [Q, k] int32), host tensors equal in every process.

    db_shards are this process's members' shards (`shard_database`), q [Q,
    S] rows (numpy or a tensor), n_live the true row count (rows past it
    are +inf).  Each member sweeps its shard with K1; on a 2-D mesh the
    two 's' members' equal counts (`equal_counts`) are summed before
    1 - eq/S."""
    cols = _col_slices(mesh, s_total)

    def step(db_shards: Sequence[torch.Tensor], q, n_live: int):
        q = _bits(q)
        if q.shape[1] != s_total:
            raise ValueError(f"queries have {q.shape[1]} slots, the database {s_total}")
        dists, ids, pair = [], [], None
        on = {}
        for (g, dev), shard in zip(mesh.members(), db_shards):
            c = cols[g % len(cols)]
            key = (dev, c.start)
            if key not in on:
                on[key] = q[:, c].contiguous().to(dev)
            d = hamming_frac(on[key], shard)  # K1
            if len(cols) == 1:
                vals, gids = _local_topk(d, g * shard.shape[0], n_live, knbn)
            elif g % 2 == 0:
                pair = equal_counts(d, c.stop - c.start)
                continue
            else:
                eq = pair + equal_counts(d, c.stop - c.start).to(pair.device)
                vals, gids = _local_topk(_distance(eq, s_total), (g // 2) * shard.shape[0], n_live, knbn)
            dists.append(vals)
            ids.append(gids)
        return _merge(mesh, dists, ids, knbn)

    return step


def sharded_sketch_and_knn_step(mesh: DeviceMesh, sketcher, block_len: int, knbn: int):
    """Data-parallel sketching of a genome batch plus the sharded exact
    search of the fresh signatures against the row-sharded database.

    Returns fn(codes [B, block_len] uint8 (numpy or tensor, B a multiple of
    the member count), db_shards) -> (sigs [B, S] numpy of the sketcher's
    signature type, d [B, k], ids [B, k] numpy): member g sketches batch
    rows [g B/D, (g+1) B/D) on its device, the signatures are gathered in
    member order, and every member's shard is searched for all of them."""
    from ..models.base import _host_form

    if "s" in mesh.axis_names:
        raise ValueError("the sketch step shards the batch only; use a 1-D ('d',) mesh "
                         "(a member's race produces all S slots)")
    s_total, dtype = sketcher.nb_slots, np.dtype(sketcher.SIG_DTYPE)
    search = sharded_knn(mesh, s_total, knbn)

    def step(codes, db_shards: Sequence[torch.Tensor]):
        if not isinstance(codes, torch.Tensor):
            codes = torch.from_numpy(np.ascontiguousarray(codes, dtype=np.uint8))
        b = codes.shape[0]
        if b % mesh.size or codes.shape[1] != block_len:
            raise ValueError(f"codes {tuple(codes.shape)}: expected [a multiple of {mesh.size}, "
                             f"{block_len}]")
        per = b // mesh.size
        parts = []
        for g, dev in mesh.members():
            rows = codes[g * per : (g + 1) * per].to(dev)
            parts.append(_host_form(sketcher._finalize_race(sketcher._race_rows(rows)), dtype))
        sigs = torch.cat(mesh.gather(parts)).numpy().view(dtype)
        d, ids = search(db_shards, sigs, mesh.size * db_shards[0].shape[0])
        return sigs, d.numpy(), ids.numpy()

    return step


class MeshSearcher:
    """Row-sharded exact k-NN over a mesh: every member holds one contiguous
    shard of the signature matrix (N padded with zero rows to a multiple of
    the member count, the pad rows masked), sweeps it with K1 and the
    lists merge in member order.  Works on any index kind's signatures;
    exact (recall 1.0).  `sigs` is host numpy (a memmap reads only this
    process's rows) or a tensor (a shard on the tensor's own device is a
    view, not a copy)."""

    def __init__(self, sigs, mesh: DeviceMesh):
        self.mesh = mesh
        self.n, self.s_total = sigs.shape
        self.db = shard_database(sigs, mesh, n_rows=_round_up(self.n, mesh.size))

    def search(self, queries, knbn: int, ef_search: int = 0):
        """(distances [Q, k], ids [Q, k]) numpy; exact, ef_search ignored."""
        del ef_search
        d, ids = sharded_knn(self.mesh, self.s_total, min(knbn, self.n))(self.db, queries, self.n)
        return d.numpy(), ids.numpy()


class MeshMxuSearcher:
    """Row-sharded compact sign-expansion k-NN: MeshSearcher's merge with
    the flat searcher's compact tier on each member (ops/mxu.py: m-sign
    expansion, the int8 product, a candidate top-k, the rerank on 16-bit
    slot hashes through K2 `parts=2`).  Each member's shard is padded to a
    multiple of MXU_SHARD_ROWS rows, so global row g lives at member
    g // rows-a-shard and ids need no remapping; the zero pad rows are
    scored like any row and masked after the member's top-k, as the
    reference does.  Near-exact: distances can differ from exact by ~2/S
    (16-bit hash collisions).  The member's candidate count is the compact
    tier's, max(2 * rerank_factor * k, 128) capped at the shard's rows,
    the reference's count."""

    def __init__(self, sigs, mesh: DeviceMesh, m: int = 2, rerank_factor: int = 8):
        if "s" in mesh.axis_names:
            raise ValueError("compact mesh search shards rows only (use a 1-D mesh)")
        self.mesh = mesh
        self.n, self.s_total = sigs.shape
        self.nl = _round_up(-(-self.n // mesh.size), MXU_SHARD_ROWS)
        self.members = [
            MxuSearcher(_rows(sigs, g * self.nl, (g + 1) * self.nl, slice(None), dev), dev, m=m,
                        rerank_factor=rerank_factor, compact=True)
            for g, dev in mesh.members()]

    def search(self, queries, knbn: int, ef_search: int = 0):
        """(distances [Q, k], ids [Q, k]) numpy; ef_search ignored."""
        del ef_search
        knbn = min(knbn, self.n)
        q = _bits(queries)
        dists, ids = [], []
        for (g, dev), searcher in zip(self.mesh.members(), self.members):
            d, sel = searcher.search_device(q.to(dev), knbn)
            gids = sel.to(torch.int64) + g * self.nl
            dists.append(torch.where(gids < self.n, d, torch.inf))
            ids.append(gids.to(torch.int32))
        d, ids = _merge(self.mesh, dists, ids, knbn)
        return d.numpy(), ids.numpy()


class MeshGraphSearcher:
    """Graph search over a mesh: member g traverses subgraph g of a
    ShardedHnswIndex (`index/hnsw._beam` over the shard's prefix, every
    shard padded to one shape), reranks its top r beam nodes through K2
    `parts=1` on the full signatures, and the members' top-k merge in shard
    order; global id = local row * D + shard (round-robin).  The mesh must
    have exactly index.n_shards members (ValueError otherwise).  `stats`
    holds the last search's hops, one count a member."""

    def __init__(self, index, mesh: DeviceMesh):
        if "s" in mesh.axis_names:
            raise ValueError("graph search shards rows only; use a 1-D mesh")
        d = mesh.size
        if d != index.n_shards:
            raise ValueError(f"mesh has {d} members but the index has {index.n_shards} shards; "
                             f"build with --mesh {d} for a {d}-member search")
        from ..ops.distance import sig_bits

        self.index, self.mesh, self.stats = index, mesh, {}
        self.s_true, self.sp = index.sketch_size, index.search_prefix
        shards = index.shards
        self.nb = nb = _next_pow2(max(sh.nb_points for sh in shards))
        tb = _next_pow2(max(max(len(sh._entry_ids) for sh in shards), 16))
        self.members = []
        for g, dev in mesh.members():
            sh = shards[g]
            n = sh.nb_points
            sigs_p = torch.full((nb + 1, self.sp), -1, dtype=torch.int32)
            sigs_p[:n] = torch.from_numpy(np.ascontiguousarray(sig_bits(sh._sigs[:, : self.sp])))
            nbrs_p = torch.full((nb + 1, sh.m0), nb, dtype=torch.int32)
            nbrs_p[:n] = torch.from_numpy(np.where(sh._nbrs == -1, nb, sh._nbrs).astype(np.int32))
            entries = torch.full((tb,), nb, dtype=torch.int32)
            entries[: len(sh._entry_ids)] = torch.from_numpy(sh._entry_ids.astype(np.int32))
            full = torch.zeros((nb + 1, self.s_true), dtype=torch.int32, device=dev)
            full[:n] = as_int32_rows(sh._sigs).to(dev)
            self.members.append((n, sigs_p.to(dev), nbrs_p.to(dev), entries.to(dev), full))

    def search(self, queries: np.ndarray, knbn: int, ef_search: int = 0):
        """(distances [Q, k], ids [Q, k]) numpy."""
        from ..index.hnsw import _beam
        from ..ops.distance import sig_bits

        nq, shard0 = queries.shape[0], self.index.shards[0]
        d_count, nb, sp = self.mesh.size, self.nb, self.sp
        knbn = min(knbn, self.index.nb_points)
        ef = max(ef_search or shard0.DEFAULT_EF, knbn)
        queries = np.ascontiguousarray(queries, dtype=self.index.sig_dtype)
        # the reference's query padding: pad rows all-ones bits (prefix) and
        # ones (full rows); the prefix pads take part in the beam's hops
        qb = _next_pow2(nq, floor=8)
        q_p = torch.full((qb, sp), -1, dtype=torch.int32)
        q_p[:nq] = torch.from_numpy(np.ascontiguousarray(sig_bits(queries[:, :sp])))
        q_full = torch.ones((qb, self.s_true), dtype=torch.int32)
        q_full[:nq] = as_int32_rows(queries)
        ef_round = _round_up(min(ef, nb), 64)
        hops = max(8, int(2 * math.log2(nb)) + ef_round // shard0.EXPAND)
        r = min(_round_up(max(4 * knbn, 32), 8), ef_round)
        k_local = min(knbn, r)
        dists, ids, self.stats = [], [], {"hops": []}
        for (g, dev), (n, sigs_p, nbrs_p, entries, full) in zip(self.mesh.members(), self.members):
            st = {}
            beam_ids, _ = _beam(sigs_p, nbrs_p, entries, q_p.to(dev), n, ef=ef_round, hops=hops,
                                expand=shard0.EXPAND, stats=st)
            self.stats["hops"].append(st["hops"])
            cand = beam_ids[:, :r].contiguous()
            dist = gather_hamming(full, q_full.to(dev), cand)  # K2 parts=1
            dist = torch.where(cand < n, dist, torch.inf)
            vals, sel = topk_smallest(dist, k_local)
            dists.append(vals)
            ids.append((cand.gather(1, sel).to(torch.int64) * d_count + g).to(torch.int32))
        d, ids = _merge(self.mesh, dists, ids, min(knbn, d_count * k_local))
        return d.numpy()[:nq], ids.numpy()[:nq]


def dryrun_multichip(n_devices: int, *, device) -> None:
    """Every mesh path on `n_devices` members of one device: the sketch-and-
    search step, MeshMxuSearcher, the 2-D sharded search (an even count of
    at least 4), and the pipeline's round trip (tohnsw -> request with the
    mesh, flat and sharded graph).  Raises on any failure."""
    from ..core import ComputingParams, HnswParams, ProcessingParams
    from ..core.params import DataType, SeqSketcherParams, SketchAlgo
    from ..index.serialize import get_index_kind
    from ..models import make_sketcher
    from ..pipeline import build_database, request_database

    device = torch.device(device)
    rng = np.random.default_rng(0)
    s = 128
    params = SeqSketcherParams(kmer_size=12, sketch_size=s, algo=SketchAlgo.OPTDENS, data_t=DataType.DNA)
    sk = make_sketcher(params, device=device)
    mesh = make_device_mesh(n_devices, device=device, devices=[device] * n_devices)
    block_len, batch = 2048, 2 * n_devices
    codes = rng.integers(0, 4, size=(batch, block_len)).astype(np.uint8)
    n = 16 * n_devices
    db = rng.integers(0, 1 << 30, size=(n, s)).astype(np.uint32)
    step = sharded_sketch_and_knn_step(mesh, sk, block_len, knbn=3)
    sigs, d, ids = step(codes, shard_database(db, mesh))
    if sigs.shape != (batch, s) or d.shape != (batch, 3) or ids.shape != (batch, 3):
        raise AssertionError(f"sketch step shapes {sigs.shape}, {d.shape}, {ids.shape}")

    dmx, imx = MeshMxuSearcher(db, mesh).search(db[:4], knbn=3)
    if dmx.shape != (4, 3) or not (imx[:, 0] == np.arange(4)).all() or not np.allclose(dmx[:, 0], 0.0):
        raise AssertionError(f"compact mesh search: rows 0-3 not their own nearest ({imx[:, 0]})")

    if n_devices % 2 == 0 and n_devices >= 4:
        mesh2 = make_device_mesh(n_devices, two_d=True, device=device, devices=[device] * n_devices)
        q = sigs.view(np.uint32)[:4]
        d2, _ = sharded_knn(mesh2, s, 3)(shard_database(db, mesh2), q, n)
        if tuple(d2.shape) != (4, 3):
            raise AssertionError(f"2-D sharded search shape {tuple(d2.shape)}")

    rng2 = np.random.default_rng(1)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    with tempfile.TemporaryDirectory() as td:
        gdir, qdir = os.path.join(td, "genomes"), os.path.join(td, "queries")
        os.makedirs(gdir)
        os.makedirs(qdir)
        genomes = [bytes(rng2.choice(acgt, 3000)) for _ in range(2 * n_devices)]
        for i, g in enumerate(genomes):
            with open(os.path.join(gdir, f"g{i}.fna"), "wb") as f:
                f.write(b">c\n" + g + b"\n")
        mut = bytearray(genomes[0])
        for p in rng2.choice(len(mut), 30, replace=False):
            mut[p] = rng2.choice(acgt)
        with open(os.path.join(qdir, "q.fna"), "wb") as f:
            f.write(b">q\n" + bytes(mut) + b"\n")
        pp = ProcessingParams(
            hnsw=HnswParams(capacity=1000, ef=64, max_nb_conn=8, scale_modification=1.0),
            sketch=SeqSketcherParams(kmer_size=12, sketch_size=s, algo=SketchAlgo.OPTDENS,
                                     data_t=DataType.DNA),
            block_flag=True)
        comp = ComputingParams(mesh_devices=n_devices)
        for kind, sub in (("auto", "db"), ("hnsw", "db_sharded")):
            out = os.path.join(td, sub)
            build_database(gdir, out, pp, comp, index_kind=kind, device=device, mesh=mesh)
            want = {"auto": "flat", "hnsw": "hnsw_sharded" if n_devices > 1 else "hnsw"}[kind]
            if get_index_kind(out)["kind"] != want:
                raise AssertionError(f"--mesh {n_devices} --index {kind} wrote {get_index_kind(out)}")
            res = request_database(out, qdir, nb_answers=3, computing=comp, out_dir=out + "_req",
                                   device=device, mesh=mesh)
            with open(res["neighbors_file"]) as f:
                if res["nb_requests"] != 1 or res["nb_matches"] < 1 or "g0.fna" not in f.read():
                    raise AssertionError(f"mesh request ({want}) did not find the mutated source")
