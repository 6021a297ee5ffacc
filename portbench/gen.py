"""Seeded inputs of the search cells: databases of signatures and query
pools (an ingest cell's genomes are written by its corpus, `corpora/`).
Everything is drawn from `--seed`; signatures on the device with one
torch.Generator, in chunks, in a fixed order, so a seed gives the same
rows whatever the device's memory.

Signatures are f32 slot values in [0, 1) with 24-bit steps, as an OptDens
signature is; two independent slots are equal with probability 2^-24, so a
pair's distance is set by the slots it shares by construction.
"""

from __future__ import annotations

import numpy as np
import torch


def _redrawn(rows: torch.Tensor, frac, gen: torch.Generator) -> torch.Tensor:
    """rows with each slot redrawn with probability frac (a scalar or a
    column of per-row fractions)."""
    mask = torch.rand(rows.shape, generator=gen, device=rows.device) < frac
    return torch.where(mask, torch.rand(rows.shape, generator=gen, device=rows.device), rows)


def species_reps(out: np.ndarray, structure: dict, gen: torch.Generator, device) -> None:
    """Fill out [n, S] with one representative a species, species grouped
    in genera and genera in families (GTDB's species clusters): a family
    root; each genus root with `genus_redraw` of its family root's slots
    redrawn; each species row with `species_redraw` of its genus root's
    redrawn.  Rows of one genus are consecutive; the genera take the rows
    evenly."""
    n, s = out.shape
    families, per_family = structure["families"], structure["genera_per_family"]
    genera = families * per_family
    fam_root = torch.rand((families, s), generator=gen, device=device)
    first = (np.arange(genera + 1, dtype=np.int64) * n) // genera  # rows of genus g: first[g]:first[g+1]
    step = 1024
    for g0 in range(0, genera, step):
        g = torch.arange(g0, min(g0 + step, genera), device=device)
        roots = _redrawn(fam_root[g // per_family], structure["genus_redraw"], gen)
        r0, r1 = int(first[g0]), int(first[g0 + len(g)])
        of_row = torch.from_numpy(np.searchsorted(first, np.arange(r0, r1), side="right") - 1 - g0)
        rows = _redrawn(roots[of_row.to(device)], structure["species_redraw"], gen)
        out[r0:r1] = rows.cpu().numpy()


def member_trees(out: np.ndarray, structure: dict, gen: torch.Generator, device) -> None:
    """Fill out [n, S] with many genomes a species (RefSeq): family roots;
    species roots with `species_redraw` of their family root's slots
    redrawn; within a species a random tree of members, each a copy of an
    earlier member (the first: of the species root) with `member_redraw`
    of its slots redrawn.  Consecutive ids share a species."""
    n, s = out.shape
    families, per_family = structure["families"], structure["species_per_family"]
    n_species = families * per_family
    per = -(-n // n_species)
    fam_root = torch.rand((families, s), generator=gen, device=device)
    step = structure.get("species_chunk", 256)
    for sp0 in range(0, n_species, step):
        sp = torch.arange(sp0, min(sp0 + step, n_species), device=device)
        root = _redrawn(fam_root[sp // per_family], structure["species_redraw"], gen)
        members = torch.empty((len(sp), per, s), device=device)
        for i in range(per):
            parent = root if i == 0 else members[
                torch.arange(len(sp), device=device),
                torch.randint(0, i, (len(sp),), generator=gen, device=device)]
            members[:, i] = _redrawn(parent, structure["member_redraw"], gen)
        start = sp0 * per
        m = min(len(sp) * per, n - start)
        if m <= 0:
            break
        out[start : start + m] = members.reshape(-1, s)[:m].cpu().numpy()


DATABASES = {"species_reps": species_reps, "member_trees": member_trees}


def database(cfg: dict, gen: torch.Generator, device) -> np.ndarray:
    """The configuration's [genomes, sketch_size] f32 signatures."""
    out = np.empty((cfg["genomes"], cfg["sketch_size"]), np.float32)
    structure = cfg["structure"]
    DATABASES[structure["kind"]](out, structure, gen, device)
    return out


def query_pool(db: np.ndarray, count: int, redraw: tuple, gen: torch.Generator, device) -> np.ndarray:
    """`count` queries, each a database row (uniform) with a fraction of
    its slots redrawn.  The fractions are the same evenly spaced set for
    every seed, in an order drawn from the seed."""
    lo, hi = redraw
    frac = lo + (hi - lo) * (torch.arange(count, device=device, dtype=torch.float64) + 0.5) / count
    frac = frac[torch.randperm(count, generator=gen, device=device)].to(torch.float32)
    src = torch.randint(0, db.shape[0], (count,), generator=gen, device=device).cpu().numpy()
    out = np.empty((count, db.shape[1]), np.float32)
    for q0 in range(0, count, 1024):
        rows = torch.from_numpy(db[src[q0 : q0 + 1024]]).to(device)
        out[q0 : q0 + len(rows)] = _redrawn(rows, frac[q0 : q0 + len(rows), None], gen).cpu().numpy()
    return out
