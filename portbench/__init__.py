"""The benchmark of gsearch_tpu_torch on NVIDIA GPUs.

`python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json and prints its result as
the last line of standard output.  Cells, configurations, traffic mixes,
limits and metrics are found by their names in BENCHMARK.json: a new one
is a new file here, and no existing file changes.  Nothing here imports
JAX or the JAX package; `reference/` imports nothing of the program.
"""
