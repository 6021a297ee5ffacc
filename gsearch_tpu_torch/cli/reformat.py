"""reformat: gsearch.neighbors.txt -> sorted TSV with ANI.

Line-format and math parity with the reference binary
(reference: src/bin/reformat.rs:7-86 — consumes lines starting
"query_id:", emits "Query_Name\tDistance\tNeighbor_Fasta_name\t
Neighbor_Seq_Len\tANI" sorted by (query, distance); ANI models at :80-85).
"""

from __future__ import annotations

import os

from ..models.ani import ani_from_distance


def _process_line(line: str, kmer: int, model: int) -> tuple:
    parts = line.split("\t")
    query_id = os.path.basename(parts[1])
    distance = float(parts[3])
    answer_fasta_path = os.path.basename(parts[5])
    # parts[7] is the literal token "answer_seq_len:" — the reference's
    # reformat has the same off-by-one (its output column carries the
    # label); kept for byte-parity with the reference's TSV
    answer_seq_len = parts[7].strip()
    ani = float(ani_from_distance(distance, kmer, model))
    return (query_id, distance, answer_fasta_path, answer_seq_len, ani)


def reformat_file(input_file: str, output_file: str, kmer: int, model: int) -> int:
    rows = []
    with open(input_file) as f:
        for line in f:
            if line.startswith("query_id:"):
                rows.append(_process_line(line.rstrip("\n"), kmer, model))
    rows.sort(key=lambda r: (r[0], r[1]))
    with open(output_file, "w") as out:
        out.write("Query_Name\tDistance\tNeighbor_Fasta_name\tNeighbor_Seq_Len\tANI\n")
        for r in rows:
            out.write(f"{r[0]}\t{r[1]}\t{r[2]}\t{r[3]}\t{r[4]}\n")
    return len(rows)
