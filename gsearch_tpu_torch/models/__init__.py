from .base import SketcherBase, make_sketcher
