"""Kaldi model readers (the port of fac_via_ppg_tpu/frontend/decode.py;
reference src/common/decode.py:23-66).

The reference exposes three readers through pykaldi; all three have real
equivalents here:

  * read_nnet3_model: the nnet3 acoustic model, text (frontend/nnet3.py)
    or Kaldi binary (frontend/nnet3_binary.py), sniffed by load_nnet3.
  * read_trans_model: the TransitionModel at the head of a binary .mdl
    file, parsed into structured data (frontend/kaldi_models.py), the
    reference's hmm.TransitionModel surface (decode.py:41-53).
  * read_den_fst: a binary OpenFst StdVectorFst, parsed into structured
    data, the reference's fstext.StdVectorFst.read (decode.py:56-66).

The accent-conversion path uses none of the last two; they exist, as in
the reference, for Kaldi decoding experiments.  `read_context_dependency`
also parses the decision tree shipped with the AM.
"""

from __future__ import annotations

from fac_via_ppg_torch.frontend.kaldi_models import (
    ContextDependency,
    TransitionModel,
    VectorFst,
    read_context_dependency,
    read_fst,
    read_transition_model,
)
from fac_via_ppg_torch.frontend.nnet3 import Nnet3, load_nnet3

__all__ = [
    "read_nnet3_model", "read_trans_model", "read_den_fst",
    "read_context_dependency", "ContextDependency", "TransitionModel",
    "VectorFst",
]


def read_nnet3_model(nnet_path: str) -> Nnet3:
    """Read an nnet3 acoustic model (reference decode.py:23-38)."""
    return load_nnet3(nnet_path)


def read_trans_model(trans_model_path: str) -> TransitionModel:
    """Read the TransitionModel header of a binary .mdl file
    (reference decode.py:41-53)."""
    return read_transition_model(trans_model_path)


def read_den_fst(den_fst_path: str) -> VectorFst:
    """Read a binary StdVectorFst, e.g. a chain den.fst
    (reference decode.py:56-66)."""
    return read_fst(den_fst_path)
