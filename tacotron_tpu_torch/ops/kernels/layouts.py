"""Host-side matrix layouts of the Hopper GEMM kernels
(``csrc/wgmma_gemm.cuh``) behind K1 (``gl_fused``) and K3 (``griffin_lim``).

The forward DFT GEMMs read their matrices with the bins interleaved per
64-bin tile: 64 real (cosine) columns, then the 64 imaginary (sine) columns
of the same bins.  One 128-wide wgmma tile then yields the re and im of the
same bins in one thread's registers, so the phase projection needs no
exchange.  The spectra come out in the same interleaved layout, and the
inverse GEMM reads its matrices stacked to match.  Both kernels take every
B operand K-major ([N, K] row-major), so the forward matrices are held
transposed as well.
"""

from __future__ import annotations

import numpy as np

#: depth of one pipeline stage: 64 bf16, one 128-byte swizzle row; every K
#: loop of the kernels is a whole number of stages
DEPTH_TILE = 64
#: bins per forward tile; their re and im columns make one 128-wide tile
BIN_TILE = 64


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def interleave_bins(re: np.ndarray, im: np.ndarray) -> np.ndarray:
    """[..., Fp] real and imaginary columns -> [..., 2 Fp], per 64-bin tile
    the 64 real columns then the 64 imaginary ones (Fp a multiple of 64)."""
    *lead, fp = re.shape
    if fp % BIN_TILE or im.shape != re.shape:
        raise ValueError(f"bins {re.shape} / {im.shape} do not tile by "
                         f"{BIN_TILE}")
    tiles = fp // BIN_TILE
    out = np.empty((*lead, tiles, 2, BIN_TILE), dtype=re.dtype)
    out[..., 0, :] = re.reshape(*lead, tiles, BIN_TILE)
    out[..., 1, :] = im.reshape(*lead, tiles, BIN_TILE)
    return out.reshape(*lead, 2 * fp)


def deinterleave_bins(x):
    """Inverse of :func:`interleave_bins` for a numpy array or a tensor:
    [..., 2 Fp] -> (re [..., Fp], im [..., Fp])."""
    *lead, n = x.shape
    tiles = n // (2 * BIN_TILE)
    split = x.reshape(*lead, tiles, 2, BIN_TILE)
    return (split[..., 0, :].reshape(*lead, tiles * BIN_TILE),
            split[..., 1, :].reshape(*lead, tiles * BIN_TILE))
