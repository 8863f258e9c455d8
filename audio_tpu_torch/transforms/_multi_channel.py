"""Multi-channel transforms of the PyTorch port: PSD, MVDR, RTFMVDR, SoudenMVDR.

The same classes and parameters as ``audio_tpu.transforms._multi_channel``.
They hold no buffers and compute on their input's device.  ``MVDR`` computes
in complex128 and casts back to the input's dtype; with ``online=True`` it
carries the running PSD matrices and mask sums from one call to the next.
"""

from __future__ import annotations

import warnings
from typing import Optional, Union

import torch
from torch import nn

from ..functional._beamforming import (
    apply_beamforming,
    mvdr_weights_rtf,
    mvdr_weights_souden,
    psd as psd_fn,
    rtf_evd,
    rtf_power,
)

__all__ = ["PSD", "MVDR", "RTFMVDR", "SoudenMVDR"]


def _get_mvdr_vector(
    psd_s, psd_n, reference_vector, solution="ref_channel", diagonal_loading=True, diag_eps=1e-7, eps=1e-8
):
    if solution == "ref_channel":
        return mvdr_weights_souden(psd_s, psd_n, reference_vector, diagonal_loading, diag_eps, eps)
    if solution == "stv_evd":
        stv = rtf_evd(psd_s)
    else:
        stv = rtf_power(psd_s, psd_n, reference_vector, diagonal_loading=diagonal_loading, diag_eps=diag_eps)
    return mvdr_weights_rtf(stv, psd_n, reference_vector, diagonal_loading, diag_eps, eps)


class PSD(nn.Module):
    def __init__(self, multi_mask: bool = False, normalize: bool = True, eps: float = 1e-15):
        super().__init__()
        self.multi_mask = multi_mask
        self.normalize = normalize
        self.eps = eps

    def forward(self, specgram: torch.Tensor, mask: Optional[torch.Tensor] = None):
        if mask is not None and self.multi_mask:
            mask = mask.mean(dim=-3)
        return psd_fn(specgram, mask, self.normalize, self.eps)


class MVDR(nn.Module):
    """MVDR beamformer with time-frequency masks (ref_channel / stv_evd / stv_power)."""

    def __init__(
        self,
        ref_channel: int = 0,
        solution: str = "ref_channel",
        multi_mask: bool = False,
        diag_loading: bool = True,
        diag_eps: float = 1e-7,
        online: bool = False,
    ):
        super().__init__()
        if solution not in ("ref_channel", "stv_evd", "stv_power"):
            raise ValueError(f'`solution` must be one of ["ref_channel", "stv_evd", "stv_power"]. Given {solution}')
        self.ref_channel = ref_channel
        self.solution = solution
        self.multi_mask = multi_mask
        self.diag_loading = diag_loading
        self.diag_eps = diag_eps
        self.online = online
        self.psd = PSD(multi_mask)
        self.psd_s = None
        self.psd_n = None
        self.mask_sum_s = None
        self.mask_sum_n = None

    def _get_updated_mvdr_vector(self, psd_s, psd_n, mask_s, mask_n, u):
        if self.multi_mask:
            mask_s = mask_s.mean(dim=-3)
            mask_n = mask_n.mean(dim=-3)
        if self.psd_s is None:
            self.psd_s = psd_s
            self.psd_n = psd_n
            self.mask_sum_s = mask_s.sum(dim=-1)
            self.mask_sum_n = mask_n.sum(dim=-1)
        else:
            sum_s = self.mask_sum_s + mask_s.sum(dim=-1)
            sum_n = self.mask_sum_n + mask_n.sum(dim=-1)
            psd_s = self.psd_s * (self.mask_sum_s / sum_s)[..., None, None] + psd_s * (1 / sum_s)[..., None, None]
            psd_n = self.psd_n * (self.mask_sum_n / sum_n)[..., None, None] + psd_n * (1 / sum_n)[..., None, None]
            self.psd_s, self.psd_n = psd_s, psd_n
            self.mask_sum_s, self.mask_sum_n = sum_s, sum_n
        return _get_mvdr_vector(psd_s, psd_n, u, self.solution, self.diag_loading, self.diag_eps)

    def forward(
        self, specgram: torch.Tensor, mask_s: torch.Tensor, mask_n: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        dtype = specgram.dtype
        if specgram.dim() < 3:
            raise ValueError(f"Expected at least 3D tensor (..., channel, freq, time). Found: {specgram.shape}")
        if not specgram.is_complex():
            raise ValueError(f"The type of ``specgram`` tensor must be complex. Found: {specgram.dtype}")
        specgram = specgram.to(torch.complex128)
        if mask_n is None:
            warnings.warn("``mask_n`` is not provided, use ``1 - mask_s`` as ``mask_n``.")
            mask_n = 1 - mask_s

        psd_s = self.psd(specgram, mask_s)
        psd_n = self.psd(specgram, mask_n)
        u = torch.zeros(specgram.shape[:-2], dtype=torch.complex128, device=specgram.device)
        u[..., self.ref_channel] = 1
        if self.online:
            w_mvdr = self._get_updated_mvdr_vector(psd_s, psd_n, mask_s, mask_n, u)
        else:
            w_mvdr = _get_mvdr_vector(psd_s, psd_n, u, self.solution, self.diag_loading, self.diag_eps)
        return apply_beamforming(w_mvdr, specgram).to(dtype)


class RTFMVDR(nn.Module):
    def forward(
        self,
        specgram: torch.Tensor,
        rtf: torch.Tensor,
        psd_n: torch.Tensor,
        reference_channel: Union[int, torch.Tensor],
        diagonal_loading: bool = True,
        diag_eps: float = 1e-7,
        eps: float = 1e-8,
    ) -> torch.Tensor:
        w_mvdr = mvdr_weights_rtf(rtf, psd_n, reference_channel, diagonal_loading, diag_eps, eps)
        return apply_beamforming(w_mvdr, specgram)


class SoudenMVDR(nn.Module):
    def forward(
        self,
        specgram: torch.Tensor,
        psd_s: torch.Tensor,
        psd_n: torch.Tensor,
        reference_channel: Union[int, torch.Tensor],
        diagonal_loading: bool = True,
        diag_eps: float = 1e-7,
        eps: float = 1e-8,
    ) -> torch.Tensor:
        w_mvdr = mvdr_weights_souden(psd_s, psd_n, reference_channel, diagonal_loading, diag_eps, eps)
        return apply_beamforming(w_mvdr, specgram)
