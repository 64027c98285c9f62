from ._build import LAUNCHES, reset_launches
from .gram_tri import gram_tri_float, gram_tri_int8
from .gibbs_group import grouped_block_update
