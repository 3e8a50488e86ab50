"""Beta-binomial alignment priors.

Port of roar_tpu/ops/priors.py: the prior on the device with `torch.lgamma`,
its numpy/scipy twin for host-side data loading, and the cached, zoomed
`BetaBinomialInterpolator`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _logbeta(x, y):
    return torch.lgamma(x) + torch.lgamma(y) - torch.lgamma(x + y)


def _logcombinations(n, k):
    return torch.lgamma(n + 1) - torch.lgamma(k + 1) - torch.lgamma(n - k + 1)


def _logbetabinom(n, a, b, x):
    return _logcombinations(n, x) + _logbeta(x + a, n - x + b) - _logbeta(a, b)


def beta_binomial_prior(
    phoneme_count: int, mel_count: int, scaling_factor: float = 1.0, device="cpu"
) -> torch.Tensor:
    """[mel_count, phoneme_count] beta-binomial alignment prior (float32).

    Row m (1-indexed) is BetaBinomial(n=P-1, a=scale*m, b=scale*(M+1-m))
    evaluated over phoneme indices 0..P-1.
    """
    x = torch.arange(0, phoneme_count, dtype=torch.float32, device=device)[None, :]
    y = torch.arange(1, mel_count + 1, dtype=torch.float32, device=device)[:, None]
    a = scaling_factor * y
    b = scaling_factor * (mel_count + 1 - y)
    n = torch.tensor(float(phoneme_count - 1), dtype=torch.float32, device=device)
    return torch.exp(_logbetabinom(n, a, b, x))


def beta_binomial_prior_np(
    phoneme_count: int, mel_count: int, scaling_factor: float = 1.0
) -> np.ndarray:
    """Numpy twin of :func:`beta_binomial_prior` for host-side data loading."""
    from scipy.special import gammaln as np_gammaln

    x = np.arange(0, phoneme_count, dtype=np.float64)[None, :]
    y = np.arange(1, mel_count + 1, dtype=np.float64)[:, None]
    a = scaling_factor * y
    b = scaling_factor * (mel_count + 1 - y)
    n = float(phoneme_count - 1)

    def logbeta(p, q):
        return np_gammaln(p) + np_gammaln(q) - np_gammaln(p + q)

    out = (
        np_gammaln(n + 1)
        - np_gammaln(x + 1)
        - np_gammaln(n - x + 1)
        + logbeta(x + a, n - x + b)
        - logbeta(a, b)
    )
    return np.exp(out).astype(np.float32)


class BetaBinomialInterpolator:
    """Cached prior with bilinear zoom: sizes are rounded to a coarse grid,
    the prior is computed once per rounded size, then zoomed to the exact
    size."""

    def __init__(self, round_mel_len_to: int = 50, round_text_len_to: int = 10, cache_size: int = 500):
        self.round_mel_len_to = round_mel_len_to
        self.round_text_len_to = round_text_len_to
        self._bank = functools.lru_cache(maxsize=cache_size)(beta_binomial_prior_np)

    @staticmethod
    def round(val: int, to: int) -> int:
        return max(1, int(np.round((val + 1) / to))) * to

    def __call__(self, w: int, h: int) -> np.ndarray:
        """w = mel length, h = text length; returns [w, h] prior."""
        from scipy import ndimage

        bw = self.round(w, self.round_mel_len_to)
        bh = self.round(h, self.round_text_len_to)
        # Quirk kept for parity with roar_tpu/ops/priors.py: the bank is
        # evaluated with the MEL length as the "phoneme_count" argument and
        # the TEXT length as "mel_count", then transposed to [mel, text].
        ret = ndimage.zoom(self._bank(bw, bh).T, zoom=(w / bw, h / bh), order=1)
        assert ret.shape[0] == w and ret.shape[1] == h, ret.shape
        return ret.astype(np.float32)
