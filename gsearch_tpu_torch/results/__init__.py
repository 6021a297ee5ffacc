from .answer import Neighbour, ReqAnswer
from .matcher import Matcher
