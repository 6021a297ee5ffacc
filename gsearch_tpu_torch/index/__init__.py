from .flat import FlatIndex
from .hnsw import HnswIndex
from .sharded import ShardedHnswIndex
from .serialize import from_jax_database, load_index
