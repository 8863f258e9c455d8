"""Importers of published wav2vec2/HuBERT/WavLM weights into the port's models: torchaudio's ``state_dict``s,
fairseq's models and state dicts, and Hugging Face transformers' models (duck-typed: neither package is imported)."""

from .import_fairseq import convert_fairseq_state_dict, import_fairseq_model, import_fairseq_state_dict
from .import_huggingface import import_huggingface_model
from .import_torch import import_torchaudio_state_dict

__all__ = [
    "convert_fairseq_state_dict",
    "import_fairseq_model",
    "import_fairseq_state_dict",
    "import_huggingface_model",
    "import_torchaudio_state_dict",
]
