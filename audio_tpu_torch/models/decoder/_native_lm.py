"""The native word n-gram LM (``csrc/host/ngram_lm.cpp``): an ARPA text file or a KenLM probing binary.

The same LM as the JAX package's ``NativeNgramLM``, in the place of flashlight's KenLM bindings in torchaudio.  It has
the ``CTCDecoderLM`` interface, so the plain Python search can score with it too; the native beam search calls
``ngram_lm_score``/``ngram_lm_finish`` directly, with no Python hop (``_native.py``).
"""

from __future__ import annotations

import ctypes

from ._ctc_decoder import CTCDecoderLM, CTCDecoderLMState

__all__ = ["NativeNgramLM"]


class NativeNgramLM(CTCDecoderLM):
    """Word n-gram LM loaded natively from an ARPA text or KenLM binary file."""

    def __init__(self, path: str, word_dict):
        from ._native import load

        lib = load()
        err = ctypes.create_string_buffer(512)
        handle = lib.ngram_lm_load(str(path).encode(), err, 512)
        if not handle:
            raise ValueError(f"failed to load language model {path!r}: {err.value.decode()}")
        self._lib = lib
        self._native_handle = handle  # picked up by NativeBeamSearch
        words = [word_dict.get_entry(i).encode() for i in range(word_dict.index_size())]
        arr = (ctypes.c_char_p * len(words))(*words)
        lib.ngram_lm_set_vocab(ctypes.c_void_p(handle), arr, len(words))
        self.order = int(lib.ngram_lm_order(ctypes.c_void_p(handle)))
        self._states = {}

    def _state(self, native_id: int) -> CTCDecoderLMState:
        st = self._states.get(native_id)
        if st is None:
            st = CTCDecoderLMState()
            st._native_id = native_id
            self._states[native_id] = st
        return st

    def start(self, start_with_nothing: bool) -> CTCDecoderLMState:
        nid = self._lib.ngram_lm_start(
            ctypes.c_void_p(self._native_handle), int(bool(start_with_nothing))
        )
        return self._state(int(nid))

    def score(self, state: CTCDecoderLMState, usr_token_idx: int):
        out = ctypes.c_double()
        nid = self._lib.ngram_lm_score(
            ctypes.c_void_p(self._native_handle), state._native_id,
            int(usr_token_idx), ctypes.byref(out),
        )
        return self._state(int(nid)), out.value

    def finish(self, state: CTCDecoderLMState):
        out = ctypes.c_double()
        nid = self._lib.ngram_lm_finish(
            ctypes.c_void_p(self._native_handle), state._native_id, ctypes.byref(out)
        )
        return self._state(int(nid)), out.value

    def __del__(self):
        lib = getattr(self, "_lib", None)
        handle = getattr(self, "_native_handle", None)
        if lib is not None and handle:
            try:
                lib.ngram_lm_free(ctypes.c_void_p(handle))
            except TypeError:  # interpreter teardown: ctypes already torn down
                pass
