from .gram_tri import LAUNCHES, gram_tri_float, gram_tri_int8, reset_launches
