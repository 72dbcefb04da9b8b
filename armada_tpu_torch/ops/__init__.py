from .select import lex_argmin, masked_min
from .bitset import bits_subset, bits_disjoint

__all__ = ["lex_argmin", "masked_min", "bits_subset", "bits_disjoint"]
