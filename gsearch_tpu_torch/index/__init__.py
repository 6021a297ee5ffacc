from .flat import FlatIndex
from .hnsw import HnswIndex
from .serialize import from_jax_database, load_index
