"""FLAC codec: the native C++ decoder (``csrc/host/flac.cpp``, through ctypes) and a numpy encoder.

The same codec as ``audio_tpu.io._flac``: torchaudio routes FLAC through torchcodec/FFmpeg, and this package reads
and writes it itself, so FLAC corpora (LibriSpeech, Libri-Light, MUSDB sources) load with no codec library.

The decoder is host code, not a kernel: ``csrc/host/flac.cpp`` is compiled with ``g++ -O3 -std=c++17 -shared -fPIC``
at first use into ``build/audio_tpu_torch/libflac_<digest>.so`` beside the package (keyed by a digest of the source
and flags, as ``models/decoder/_native.py`` keys the CTC decoder's core).  Nothing is caught: a missing ``g++`` or a
compile error raises.

The encoder is pure numpy and follows the specification: constant / fixed (0-4) / LPC subframes chosen per block,
rice / rice2 residual coding, optional left-side / mid-side stereo decorrelation, wasted bits, frame CRC-8/CRC-16.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np

from ..ops._build import BUILD_DIR

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "host" / "flac.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_LIB = None

_BLOCK = 4096
_FIXED_COEFS = {
    0: np.array([], np.int64),
    1: np.array([1], np.int64),
    2: np.array([2, -1], np.int64),
    3: np.array([3, -3, 1], np.int64),
    4: np.array([4, -6, 4, -1], np.int64),
}
_SS_CODE = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}
_SR_CODE = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
            24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11}


# --------------------------------------------------------------------------
# native decoder
# --------------------------------------------------------------------------

def library_path() -> Path:
    """Where the decoder's library is (or will be) built: keyed by a digest of the source and flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libflac_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the decoder with ``g++`` unless it is built already; raises if the compiler is missing or fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / path.name
        proc = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(out)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"g++ failed to build the FLAC decoder:\n{proc.stderr}")
        out.replace(path)
    return path


def _load_lib():
    """The decoder's ``ctypes`` library, built at first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    lib.flac_probe.restype = ctypes.c_int
    lib.flac_probe.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)]
    lib.flac_decode.restype = ctypes.c_int
    lib.flac_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_int64)]
    _LIB = lib
    return lib


def probe_flac(data: bytes) -> Tuple[int, int, int, int]:
    """(sample_rate, channels, bits_per_sample, total_frames) from STREAMINFO."""
    lib = _load_lib()
    inf = (ctypes.c_int32 * 5)()
    if lib.flac_probe(data, len(data), inf) != 0:
        raise ValueError("Not a valid FLAC stream")
    total = int(inf[3]) & 0xFFFFFFFF | (int(inf[4]) << 32)
    return int(inf[0]), int(inf[1]), int(inf[2]), total


def decode_flac(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Decode a FLAC stream -> (samples int32 (frames, channels), rate, bits)."""
    lib = _load_lib()
    rate, nch, bits, total = probe_flac(data)
    if total == 0:  # STREAMINFO may omit the length (streamed encodes)
        total = (len(data) * 8 // max(bits // 2, 1)) // nch + 65536
    written = ctypes.c_int64(0)
    for _ in range(16):  # grow-and-retry: -6 = capacity exceeded
        out = np.empty(total * nch, np.int32)
        rc = lib.flac_decode(
            data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out.size, ctypes.byref(written),
        )
        if rc != -6:
            break
        total *= 8
    if rc != 0:
        raise ValueError(f"FLAC decode failed (code {rc})")
    return out[: written.value * nch].reshape(-1, nch), rate, bits


# --------------------------------------------------------------------------
# encoder (pure numpy)
# --------------------------------------------------------------------------

class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, n: int):
        if n == 0:
            return
        self.acc = (self.acc << n) | (int(value) & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_signed(self, value: int, n: int):
        self.write(int(value) & ((1 << n) - 1), n)

    def write_unary(self, q: int):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


_CRC16_TABLE = None


def _crc16(data: bytes) -> int:
    global _CRC16_TABLE
    if _CRC16_TABLE is None:
        table = []
        for i in range(256):
            crc = i << 8
            for _ in range(8):
                crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
            table.append(crc)
        _CRC16_TABLE = table
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ _CRC16_TABLE[((crc >> 8) ^ b) & 0xFF]
    return crc


def _utf8_number(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out, bits_left = [], 0
    for extra, prefix, cap in ((1, 0xC0, 11), (2, 0xE0, 16), (3, 0xF0, 21),
                               (4, 0xF8, 26), (5, 0xFC, 31), (6, 0xFE, 36)):
        if n < (1 << cap):
            out.append(prefix | (n >> (6 * extra)) if prefix != 0xFE else 0xFE)
            for i in range(extra - 1, -1, -1):
                out.append(0x80 | ((n >> (6 * i)) & 0x3F))
            return bytes(out)
    raise ValueError("frame number too large")


def _rice_param(u: np.ndarray) -> int:
    best_k, best_cost = 0, None
    for k in range(31):
        cost = int((u >> np.uint64(k)).sum()) + u.size * (k + 1)
        if best_cost is None or cost < best_cost:
            best_k, best_cost = k, cost
    return best_k


def _write_residual(bw: _BitWriter, res: np.ndarray, order: int, blocksize: int,
                    partition_order: int = 0):
    r = res.astype(np.int64)
    u = np.where(r >= 0, 2 * r, -2 * r - 1).astype(np.uint64)
    if blocksize % (1 << partition_order) or (blocksize >> partition_order) <= order:
        partition_order = 0
    psize = blocksize >> partition_order
    # pick params per partition; promote to rice2 if any needs > 14 bits
    bounds = [(max(0, p * psize - order), (p + 1) * psize - order)
              for p in range(1 << partition_order)]
    params = [_rice_param(u[a:b]) for a, b in bounds]
    method = 0 if max(params) <= 14 else 1
    bw.write(method, 2)
    bw.write(partition_order, 4)
    for (a, b), k in zip(bounds, params):
        bw.write(k, 5 if method else 4)
        for val in u[a:b].tolist():
            bw.write_unary(int(val) >> k)
            if k:
                bw.write(int(val) & ((1 << k) - 1), k)


kMAX_FIXED = 4


def _wasted_bits(x: np.ndarray, bps: int) -> int:
    acc = 0
    for v in x.tolist():
        acc |= int(v)
    if acc == 0:
        return 0
    w = (acc & -acc).bit_length() - 1  # trailing zeros of the OR
    return min(w, bps - 1)


def _encode_subframe(bw: _BitWriter, x: np.ndarray, bps: int, use_lpc: bool,
                     partition_order: int = 0, force_verbatim: bool = False):
    x64 = x.astype(np.int64)
    blocksize = len(x64)
    wasted = 0 if force_verbatim else _wasted_bits(x64, bps)
    if wasted:
        x64 = x64 >> wasted
        bps -= wasted

    def header(type_code: int):
        bw.write(0, 1)
        bw.write(type_code, 6)
        if wasted:
            bw.write(1, 1)
            bw.write_unary(wasted - 1)
        else:
            bw.write(0, 1)

    if force_verbatim:
        header(1)
        for v in x64.tolist():
            bw.write_signed(int(v), bps)
        return
    if np.all(x64 == x64[0]):
        header(0)
        bw.write_signed(int(x64[0]), bps)
        return
    best_order, best_cost = 0, None
    for order in range(min(kMAX_FIXED, blocksize - 1) + 1):
        cost = int(np.abs(_fixed_residual(x64, order)).sum())
        if best_cost is None or cost < best_cost:
            best_order, best_cost = order, cost
    if use_lpc and blocksize > 64:
        lpc = _lpc_analyze(x64, order=8, precision=12)
        if lpc is not None and np.abs(lpc[3]).sum() * 1.05 < best_cost:
            order, coefs, shift, res = lpc
            header(32 + order - 1)
            for i in range(order):
                bw.write_signed(int(x64[i]), bps)
            bw.write(12 - 1, 4)
            bw.write_signed(shift, 5)
            for c in coefs:
                bw.write_signed(int(c), 12)
            _write_residual(bw, res, order, blocksize, partition_order)
            return
    res = _fixed_residual(x64, best_order)
    header(8 + best_order)
    for i in range(best_order):
        bw.write_signed(int(x64[i]), bps)
    _write_residual(bw, res, best_order, blocksize, partition_order)


def _fixed_residual(x: np.ndarray, order: int) -> np.ndarray:
    res = x.copy()
    for _ in range(order):
        res = np.diff(res)
    return res


def _lpc_analyze(x: np.ndarray, order: int, precision: int):
    """Levinson-Durbin LPC; returns (order, quantized coefs, shift, residual)."""
    xf = x.astype(np.float64)
    n = len(xf)
    autoc = np.array([np.dot(xf[: n - k], xf[k:]) for k in range(order + 1)])
    if autoc[0] <= 0:
        return None
    err = autoc[0]
    a = np.zeros(order)
    for i in range(order):
        acc = autoc[i + 1] - np.dot(a[:i], autoc[i:0:-1][:i])
        k = acc / err
        a[: i + 1] = np.concatenate([a[:i] - k * a[:i][::-1], [k]])
        err *= 1 - k * k
        if err <= 0:
            return None
    cmax = np.abs(a).max()
    if cmax == 0 or not np.isfinite(cmax):
        return None
    shift = precision - 1 - max(0, int(np.floor(np.log2(cmax))) + 1)
    shift = int(np.clip(shift, 0, 15))
    q = np.clip(np.round(a * (1 << shift)), -(1 << (precision - 1)),
                (1 << (precision - 1)) - 1).astype(np.int64)
    if np.all(q == 0):
        return None
    # integer residual exactly as the decoder predicts
    hist = np.stack([x[order - 1 - j : n - 1 - j] for j in range(order)])  # (order, n-order)
    pred = (q @ hist) >> shift
    res = x[order:] - pred
    return order, q, shift, res


def encode_flac(
    samples: np.ndarray,
    sample_rate: int,
    bits_per_sample: int = 16,
    block_size: int = _BLOCK,
    stereo_mode: str = "independent",
    use_lpc: bool = True,
    partition_order: int = 0,
    force_verbatim: bool = False,
) -> bytes:
    """Encode int samples (frames, channels) to a FLAC stream."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    n, nch = x.shape
    if bits_per_sample not in _SS_CODE:
        raise ValueError(f"unsupported bits_per_sample {bits_per_sample}")
    if stereo_mode != "independent" and nch != 2:
        raise ValueError("stereo decorrelation requires 2 channels")

    out = bytearray(b"fLaC")
    streaminfo = _BitWriter()
    streaminfo.write(block_size, 16)
    streaminfo.write(block_size, 16)
    streaminfo.write(0, 24); streaminfo.write(0, 24)
    streaminfo.write(sample_rate, 20)
    streaminfo.write(nch - 1, 3)
    streaminfo.write(bits_per_sample - 1, 5)
    streaminfo.write(n & ((1 << 36) - 1), 36)
    for _ in range(16):
        streaminfo.write(0, 8)  # MD5 unset
    si = streaminfo.bytes()
    out += bytes([0x80]) + len(si).to_bytes(3, "big") + si

    sr_code = _SR_CODE.get(sample_rate, 0)
    ss_code = _SS_CODE[bits_per_sample]

    frame_no = 0
    for start in range(0, n, block_size):
        blk = x[start : start + block_size].astype(np.int64)
        bs = blk.shape[0]
        if stereo_mode == "independent" or nch != 2:
            ch_code, subs, sub_bps = nch - 1, [blk[:, c] for c in range(nch)], [bits_per_sample] * nch
        elif stereo_mode == "left_side":
            side = blk[:, 0] - blk[:, 1]
            ch_code, subs = 8, [blk[:, 0], side]
            sub_bps = [bits_per_sample, bits_per_sample + 1]
        elif stereo_mode == "mid_side":
            side = blk[:, 0] - blk[:, 1]
            mid = (blk[:, 0] + blk[:, 1]) >> 1
            ch_code, subs = 10, [mid, side]
            sub_bps = [bits_per_sample, bits_per_sample + 1]
        else:
            raise ValueError(f"unknown stereo_mode {stereo_mode}")

        hdr = _BitWriter()
        hdr.write(0x3FFE, 14)
        hdr.write(0, 1)  # reserved
        hdr.write(0, 1)  # fixed blocksize strategy
        hdr.write(7, 4)  # blocksize: 16-bit value follows
        hdr.write(sr_code, 4)
        hdr.write(ch_code, 4)
        hdr.write(ss_code, 3)
        hdr.write(0, 1)
        hdr_bytes = hdr.bytes() + _utf8_number(frame_no)
        hdr_bytes += int(bs - 1).to_bytes(2, "big")
        hdr_bytes += bytes([_crc8(hdr_bytes)])

        body = _BitWriter()
        for sub, bps in zip(subs, sub_bps):
            _encode_subframe(body, sub, bps, use_lpc, partition_order, force_verbatim)
        body.align()
        frame = hdr_bytes + body.bytes()
        frame += _crc16(frame).to_bytes(2, "big")
        out += frame
        frame_no += 1

    return bytes(out)
