"""Data (port of ``repro.data``): the WordPiece tokenizer and the synthetic
CLUE-like task pipeline, numpy-only copies of the JAX package's modules."""
from repro_torch.data import pipeline, tokenizer
from repro_torch.data.pipeline import (TaskSpec, eval_accuracy, get_batch,
                                      make_task)
from repro_torch.data.tokenizer import WordPieceTokenizer

__all__ = ["pipeline", "tokenizer", "TaskSpec", "eval_accuracy", "get_batch",
           "make_task", "WordPieceTokenizer"]
