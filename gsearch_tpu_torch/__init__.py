"""gsearch_tpu_torch — the gsearch_tpu genome sketch-and-search system in
PyTorch, with its distance kernels hand-written in CUDA for Hopper (sm_90a).

The package mirrors `gsearch_tpu`'s layout (ops/, models/, index/, cli/,
utils/, pipeline.py) so each module has a visible counterpart.  It imports
neither JAX nor any module of `gsearch_tpu`: the host modules (io, core,
results) are its own copies, everything else is written here on torch
tensors with an explicit `torch.device` passed down from the entry point.

Databases are interchangeable: both packages read and write the same
five-file layout (index/serialize.py).
"""

__version__ = "0.1.0"
