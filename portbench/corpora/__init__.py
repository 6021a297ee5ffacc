"""Corpus writers of the ingest cells, one module a corpus, found by the
name an ingest traffic mix gives (`"corpus"`, `genomes` where it gives
none)."""
