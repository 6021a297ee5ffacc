"""k2_roofline: K2 (`gather_hamming` -> csrc/hamming.cu) against its
roofline: each call's bytes (the distinct rows its ids reference, the
query lanes, the ids and the output, each once) over HBM's rate, summed
over the window's calls, over their CUDA-event times.  The operations (one
a lane compare) are printed beside it on standard error."""

from portbench.readers import k2_roofline as read  # noqa: F401
