"""The CTC decoders of the PyTorch port: the lexicon beam-search decoder with word LMs on the host (its native core
built with ``g++`` from ``csrc/host/``), and the batched prefix beam search on the card (``cuda_ctc_decoder``)."""

from ._batch_ctc_decoder import CUCTCDecoder, CUCTCHypothesis, batch_ctc_prefix_beam_search, cuda_ctc_decoder
from ._ctc_decoder import (
    CTCDecoder,
    CTCDecoderLM,
    CTCDecoderLMState,
    CTCHypothesis,
    ctc_decoder,
    download_pretrained_files,
)
from ._kenlm_io import build_binary_lm

__all__ = [
    "CTCDecoder",
    "CTCDecoderLM",
    "CTCDecoderLMState",
    "CTCHypothesis",
    "CUCTCDecoder",
    "CUCTCHypothesis",
    "batch_ctc_prefix_beam_search",
    "build_binary_lm",
    "ctc_decoder",
    "cuda_ctc_decoder",
    "download_pretrained_files",
]
