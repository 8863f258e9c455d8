"""Recurrence engines and the hand-written CUDA kernels with their plain versions.

Kernel modules: ``cuda_iir`` (K1, lfilter, and K4, the all-pole recurrence of
its gradient), ``cuda_spectrogram`` (K2, power and mel spectrogram),
``cuda_viterbi`` (K3, forced-alignment Viterbi), ``cuda_rnnt_lps`` (K5 join +
row statistics + top-k, K6 row statistics + top-k, K8 lattice row statistics),
``cuda_lstm`` (K7, layer-norm LSTM step) and ``cuda_attention`` (K9, fused
Emformer attention, forward and backward).  Each holds a ``launches`` counter of
its kernels: an integer (``cuda_iir`` has ``launches`` for K1 and
``iir_launches`` for K4), or in ``cuda_rnnt_lps`` and ``cuda_attention`` a dict
by kernel name.  ``rnnt`` and ``rnnt_pruned`` hold the transducer losses' DP,
which reads the lattice through K8; ``ctc`` holds the CTC loss (the trellis's
forward recurrence in the log semiring, differentiated by autograd) and the
greedy decoder.
"""
