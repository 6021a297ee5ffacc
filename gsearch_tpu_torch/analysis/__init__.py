from .kgraph import Hubness, KGraph, kgraph_from_index
from .embed import Embedder, EmbedderParams, get_graph_stats_embed
