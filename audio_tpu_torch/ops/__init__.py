"""Recurrence engines and the hand-written CUDA kernels with their plain versions.

Kernel modules: ``cuda_iir`` (K1, lfilter), ``cuda_spectrogram`` (K2, power
and mel spectrogram), ``cuda_viterbi`` (K3, forced-alignment Viterbi),
``cuda_rnnt_lps`` (K5 join + row statistics + top-k, K6 row statistics +
top-k, K8 lattice row statistics) and ``cuda_lstm`` (K7, layer-norm LSTM
step).  Each holds a ``launches`` counter of its kernels: an integer, or in
``cuda_rnnt_lps`` a dict by kernel name.
"""
