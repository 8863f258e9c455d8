"""Recurrence engines and the hand-written CUDA kernels with their plain versions.

Kernel modules: ``cuda_iir`` (K1, lfilter), ``cuda_spectrogram`` (K2, power
and mel spectrogram), ``cuda_viterbi`` (K3, forced-alignment Viterbi).  Each
holds an integer ``launches`` counter of its kernel.
"""
