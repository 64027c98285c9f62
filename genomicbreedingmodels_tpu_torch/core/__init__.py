from .structs import *
from .simulation import *
from .grm import *
