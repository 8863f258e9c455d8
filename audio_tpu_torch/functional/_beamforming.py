"""Multi-channel beamforming ops (PSD, MVDR, RTF), on the device of their input.

Same semantics as ``audio_tpu.functional._beamforming``: complex linear
algebra through ``torch.linalg`` (``solve``, ``eigh``) and ``torch.einsum``.
``rtf_evd`` returns an eigenvector, which any eigensolver may give times a
unit-modulus factor of its own choice.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = [
    "psd",
    "mvdr_weights_souden",
    "mvdr_weights_rtf",
    "rtf_evd",
    "rtf_power",
    "apply_beamforming",
]


def psd(
    specgram: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    normalize: bool = True,
    eps: float = 1e-10,
) -> torch.Tensor:
    """Cross-channel PSD matrix: (..., channel, freq, time) -> (..., freq, channel, channel).

    The sum over time of each frame's outer product, weighted by ``mask``,
    without forming the outer products one by one.
    """
    specgram = specgram.transpose(-3, -2)  # (..., freq, channel, time)
    if mask is not None:
        if mask.shape[:-1] != specgram.shape[:-2] or mask.shape[-1] != specgram.shape[-1]:
            raise ValueError(
                "The dimensions of mask except the channel dimension should be the same as specgram. "
                f"Found {mask.shape} for mask and {specgram.shape} for specgram."
            )
        if normalize:
            mask = mask / (mask.sum(dim=-1, keepdim=True) + eps)
        return torch.einsum("...ct,...et,...t->...ce", specgram, specgram.conj(), mask.to(specgram.dtype))
    return torch.einsum("...ct,...et->...ce", specgram, specgram.conj())


def _mat_trace(x: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(x, dim1=-2, dim2=-1).sum(-1)


def _tik_reg(mat: torch.Tensor, reg: float = 1e-7, eps: float = 1e-8) -> torch.Tensor:
    c = mat.shape[-1]
    eye = torch.eye(c, dtype=mat.dtype, device=mat.device)
    epsilon = _mat_trace(mat).real[..., None, None] * reg + eps
    return mat + epsilon * eye


def _assert_psd_matrices(psd_s: torch.Tensor, psd_n: torch.Tensor) -> None:
    if psd_s.dim() < 3 or psd_n.dim() < 3:
        raise ValueError(
            "Expected at least 3D Tensor (..., freq, channel, channel) for psd_s and psd_n. "
            f"Found {psd_s.shape} for psd_s and {psd_n.shape} for psd_n."
        )
    if not (psd_s.is_complex() and psd_n.is_complex()):
        raise TypeError("The type of psd_s and psd_n must be complex.")
    if psd_s.shape != psd_n.shape:
        raise ValueError(f"The dimensions of psd_s and psd_n should be the same. Found {psd_s.shape} and {psd_n.shape}.")
    if psd_s.shape[-1] != psd_s.shape[-2]:
        raise ValueError(f"The last two dimensions of psd_s should be the same. Found {psd_s.shape}.")


def mvdr_weights_souden(
    psd_s: torch.Tensor,
    psd_n: torch.Tensor,
    reference_channel: Union[int, torch.Tensor],
    diagonal_loading: bool = True,
    diag_eps: float = 1e-7,
    eps: float = 1e-8,
) -> torch.Tensor:
    """MVDR weights via the Souden formula; returns (..., freq, channel)."""
    _assert_psd_matrices(psd_s, psd_n)
    if diagonal_loading:
        psd_n = _tik_reg(psd_n, reg=diag_eps)
    numerator = torch.linalg.solve(psd_n, psd_s)
    ws = numerator / (_mat_trace(numerator)[..., None, None] + eps)
    if isinstance(reference_channel, int):
        return ws[..., :, reference_channel]
    ref = reference_channel.to(psd_n.dtype)
    return torch.einsum("...fce,...e->...fc", ws, ref)


def mvdr_weights_rtf(
    rtf: torch.Tensor,
    psd_n: torch.Tensor,
    reference_channel: Optional[Union[int, torch.Tensor]] = None,
    diagonal_loading: bool = True,
    diag_eps: float = 1e-7,
    eps: float = 1e-8,
) -> torch.Tensor:
    """MVDR weights from an RTF/steering vector; returns (..., freq, channel)."""
    if rtf.dim() < 2:
        raise ValueError(f"Expected at least 2D Tensor (..., freq, channel) for rtf. Found {rtf.shape}.")
    if psd_n.dim() < 3:
        raise ValueError(f"Expected at least 3D Tensor (..., freq, channel, channel) for psd_n. Found {psd_n.shape}.")
    if not (rtf.is_complex() and psd_n.is_complex()):
        raise TypeError("The type of rtf and psd_n must be complex.")
    if rtf.shape != psd_n.shape[:-1]:
        raise ValueError(
            "The dimensions of rtf and psd_n (without its last dimension) should match. "
            f"Found {rtf.shape} for rtf and {psd_n.shape} for psd_n."
        )
    if psd_n.shape[-1] != psd_n.shape[-2]:
        raise ValueError(f"The last two dimensions of psd_n should be the same. Found {psd_n.shape}.")
    if diagonal_loading:
        psd_n = _tik_reg(psd_n, reg=diag_eps)
    numerator = torch.linalg.solve(psd_n, rtf[..., None])[..., 0]
    denominator = torch.einsum("...d,...d->...", rtf.conj(), numerator)
    weights = numerator / (denominator.real[..., None] + eps)
    if reference_channel is not None:
        if isinstance(reference_channel, int):
            scale = rtf[..., reference_channel].conj()
        else:
            ref = reference_channel.to(psd_n.dtype)
            scale = torch.einsum("...fc,...c->...f", rtf.conj(), ref)
        weights = weights * scale[..., None]
    return weights


def rtf_evd(psd_s: torch.Tensor) -> torch.Tensor:
    """RTF via eigendecomposition (the eigenvector of the largest eigenvalue), up to a
    unit-modulus factor the eigensolver chooses."""
    if not psd_s.is_complex():
        raise TypeError(f"The type of psd_s must be complex. Found {psd_s.dtype}.")
    if psd_s.shape[-1] != psd_s.shape[-2]:
        raise ValueError(f"The last two dimensions of psd_s should be the same. Found {psd_s.shape}.")
    _, v = torch.linalg.eigh(psd_s)  # ascending eigenvalues
    return v[..., -1]


def rtf_power(
    psd_s: torch.Tensor,
    psd_n: torch.Tensor,
    reference_channel: Union[int, torch.Tensor],
    n_iter: int = 3,
    diagonal_loading: bool = True,
    diag_eps: float = 1e-7,
) -> torch.Tensor:
    """RTF via the power method; returns (..., freq, channel)."""
    _assert_psd_matrices(psd_s, psd_n)
    if n_iter <= 0:
        raise ValueError("The number of iteration must be greater than 0.")
    if diagonal_loading:
        psd_n = _tik_reg(psd_n, reg=diag_eps)
    phi = torch.linalg.solve(psd_n, psd_s)
    if isinstance(reference_channel, int):
        rtf = phi[..., reference_channel]
    else:
        ref = reference_channel.to(psd_n.dtype)
        rtf = torch.einsum("...fce,...e->...fc", phi, ref)
    rtf = rtf[..., None]
    if n_iter >= 2:
        for _ in range(n_iter - 2):
            rtf = phi @ rtf
        rtf = psd_s @ rtf
    else:
        rtf = psd_n @ rtf
    return rtf[..., 0]


def apply_beamforming(beamform_weights: torch.Tensor, specgram: torch.Tensor) -> torch.Tensor:
    """w^H Y: (..., freq, channel) x (..., channel, freq, time) -> (..., freq, time)."""
    if beamform_weights.shape[:-2] != specgram.shape[:-3]:
        raise ValueError(
            "The leading dimensions of beamform_weights and specgram must match. "
            f"Found {beamform_weights.shape} for beamform_weights and {specgram.shape} for specgram."
        )
    if not (beamform_weights.is_complex() and specgram.is_complex()):
        raise TypeError("The type of beamform_weights and specgram must be complex.")
    return torch.einsum("...fc,...cft->...ft", beamform_weights.conj(), specgram)
