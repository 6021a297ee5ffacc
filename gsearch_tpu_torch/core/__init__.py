from .params import (
    ComputingParams,
    DataType,
    HnswParams,
    ProcessingParams,
    SeqSketcherParams,
    SketchAlgo,
)
from .seqdict import Id, ItemDict, SeqDict
from .state import ProcessingState
