"""CPU-reference pYIN (numpy/scipy, single-threaded).

The port's copy of roar_tpu/ops/pyin_reference.py: a numpy (float64)
implementation of the same pYIN pipeline as roar_tpu_torch.ops.pyin,
structured like librosa.pyin.  Its arithmetic uses neither torch nor jax
(only the config and two static tables come from the port), so it is the
independent oracle for the device path wherever the port runs: the tests
hold it to the synthesis-truth fixtures, and the card run compares the
device's voicing with it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from roar_tpu_torch.ops.pyin import PyinConfig, _band_tables, _beta_probs

_TINY = np.finfo(np.float32).tiny


def pyin_cpu(y: np.ndarray, cfg: PyinConfig) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Single-utterance pYIN on CPU.  Returns (f0, voiced_flag, voiced_prob)."""

    fl, w, hop = cfg.frame_length, cfg.win, cfg.hop
    if cfg.center:
        y = np.pad(y, (fl // 2, fl // 2))
    n_frames = (len(y) - fl) // hop + 1
    idx = np.arange(n_frames)[:, None] * hop + np.arange(fl)[None, :]
    frames = y[idx].astype(np.float64)  # [T, fl]

    # --- CMNDF ---
    a = np.fft.rfft(frames, fl, axis=-1)
    b = np.fft.rfft(frames[:, w::-1], fl, axis=-1)
    acf = np.fft.irfft(a * b, fl, axis=-1)[:, w:]
    acf[np.abs(acf) < 1e-6] = 0
    cum = np.cumsum(frames**2, axis=-1)
    energy = cum[:, w:] - cum[:, :-w]
    energy[np.abs(energy) < 1e-6] = 0
    d = energy[:, :1] + energy - 2 * acf
    tau = np.arange(1, cfg.max_period + 1)
    cmean = np.cumsum(d[:, 1 : cfg.max_period + 1], axis=-1) / tau
    yin = d[:, cfg.min_period : cfg.max_period + 1] / (
        cmean[:, cfg.min_period - 1 : cfg.max_period] + _TINY
    )  # [T, P]

    # --- parabolic shifts ---
    shifts = np.zeros_like(yin)
    a2 = (yin[:, :-2] + yin[:, 2:] - 2 * yin[:, 1:-1]) / 2
    b2 = (yin[:, 2:] - yin[:, :-2]) / 2
    s = -b2 / (2 * a2 + _TINY)
    s[np.abs(s) > 1] = 0
    shifts[:, 1:-1] = s

    # --- trough priors (fully vectorized across frames; Boltzmann pmf in
    # closed form — scipy.stats dispatch per frame would be a straw-man
    # baseline) ---
    thresholds = np.linspace(0, 1, cfg.n_thresholds + 1)
    beta_probs = _beta_probs(cfg.n_thresholds, cfg.beta_a, cfg.beta_b).astype(np.float64)
    t_count, p = yin.shape
    is_trough = np.zeros((t_count, p), bool)
    is_trough[:, 0] = yin[:, 0] < yin[:, 1]
    is_trough[:, 1:-1] = (yin[:, 1:-1] < yin[:, :-2]) & (yin[:, 1:-1] <= yin[:, 2:])
    heights = np.where(is_trough, yin, np.inf)
    below = is_trough[:, :, None] & (heights[:, :, None] < thresholds[None, None, 1:])
    rank = np.cumsum(below, axis=1) - 1
    n_troughs = below.sum(axis=1, keepdims=True)
    lam = cfg.boltzmann_parameter
    pmf = (
        (1 - np.exp(-lam))
        * np.exp(-lam * rank)
        / (1 - np.exp(-lam * np.maximum(n_troughs, 1)))
    )
    pmf[~below] = 0
    probs = pmf @ beta_probs  # [T, P]
    gmin = heights.argmin(axis=1)
    min_h = heights.min(axis=1)
    beta_cdf = np.cumsum(beta_probs)
    n_empty = (thresholds[None, 1:] <= min_h[:, None]).sum(axis=1)
    bonus = np.where(n_empty > 0, beta_cdf[np.maximum(n_empty - 1, 0)], 0.0)
    has_trough = is_trough.any(axis=1)
    probs[np.arange(t_count), gmin] += cfg.no_trough_prob * bonus * has_trough

    # --- observations ---
    n_bins = cfg.n_pitch_bins
    periods = cfg.min_period + np.arange(p)[None, :] + shifts
    f0c = cfg.sample_rate / np.maximum(periods, 1e-6)
    bin_idx = np.clip(
        np.round(12 * cfg.n_bins_per_semitone * np.log2(f0c / cfg.fmin)), 0, n_bins - 1
    ).astype(np.int64)
    obs = np.zeros((t_count, 2 * n_bins))
    for t in range(t_count):
        np.add.at(obs[t], bin_idx[t], probs[t])
    voiced_prob = np.clip(obs[:, :n_bins].sum(-1), 0, 1)
    obs[:, n_bins:] = (1 - voiced_prob[:, None]) / n_bins

    # --- Viterbi (banded, the same structure as the device path) ---
    log_tri, log_norm = _band_tables(n_bins, cfg.transition_width)
    half = cfg.transition_width // 2
    log_stay = np.log1p(-cfg.switch_prob)
    log_switch = np.log(cfg.switch_prob)
    log_obs = np.where(obs > 0, np.log(np.maximum(obs, 1e-300)), -700.0)
    v = np.full(2 * n_bins, -1e30)
    v[n_bins:] = np.log(1.0 / n_bins)
    v = v + log_obs[0]
    ptr = np.zeros((t_count, 2 * n_bins), np.int32)
    sw = np.lib.stride_tricks.sliding_window_view
    bins = np.arange(n_bins, dtype=np.int32)
    for t in range(1, t_count):
        u_v = v[:n_bins] - log_norm
        u_u = v[n_bins:] - log_norm
        w_same = np.maximum(u_v + log_stay, u_u + log_switch)
        w_cross = np.maximum(u_v + log_switch, u_u + log_stay)
        src_is_u_same = (u_u + log_switch) > (u_v + log_stay)
        src_is_u_cross = (u_u + log_stay) > (u_v + log_switch)
        for k, (wv, s_u) in enumerate(
            ((w_same, src_is_u_same), (w_cross, src_is_u_cross))
        ):
            padded = np.pad(wv, half, constant_values=-1e30)
            windows = sw(padded, 2 * half + 1) + log_tri[None, :]
            off = windows.argmax(-1).astype(np.int32)
            best = windows.max(-1)
            src = np.clip(bins - half + off, 0, n_bins - 1)
            ptr[t, k * n_bins : (k + 1) * n_bins] = src + s_u[src] * n_bins
            v[k * n_bins : (k + 1) * n_bins] = best
        v = v + log_obs[t]
    states = np.zeros(t_count, np.int64)
    states[-1] = v.argmax()
    for t in range(t_count - 1, 0, -1):
        states[t - 1] = ptr[t, states[t]]

    freqs = cfg.freqs()
    f0 = freqs[states % n_bins]
    voiced = states < n_bins
    f0 = np.where(voiced, f0, cfg.fill_na)
    return f0.astype(np.float32), voiced, voiced_prob.astype(np.float32)
