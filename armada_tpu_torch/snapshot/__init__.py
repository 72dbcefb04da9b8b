from .vocab import TaintVocab, LabelVocab
from .round import RoundSnapshot, build_round_snapshot

__all__ = ["TaintVocab", "LabelVocab", "RoundSnapshot", "build_round_snapshot"]
