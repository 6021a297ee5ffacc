from .flat import FlatIndex
from .serialize import from_jax_database, load_index
