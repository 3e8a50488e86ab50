"""Batched pYIN pitch tracking in PyTorch.

Port of roar_tpu/ops/pyin.py (pYIN, Mauch & Dixon 2014, with librosa's
semantics and defaults):

1. CMNDF per frame from an FFT autocorrelation (`torch.fft`).
2. Parabolic interpolation of trough positions.
3. Trough priors: beta-distributed threshold sweep and Boltzmann weighting
   over trough rank, on the troughs compacted into K slots.
4. An HMM over 2N states (N voiced pitch bins and their unvoiced twins) with
   a banded triangle transition, decoded by the two Viterbi kernels of
   `roar_tpu_torch.kernels.pyin_viterbi`.

What the JAX module does to keep gathers, scatters and FFTs off the TPU
(one-hot contractions, a triangular-matrix rank, a [P*W, n_bins] scatter
matrix, the DFT as matrix products) is not carried over: this module uses
`cumsum`, `gather`, `scatter_` and `torch.fft`.  Results stay deterministic:
every `scatter_` writes distinct positions (plus one dump column that is
dropped), and the sum of several periods into one pitch bin in
`observation_probs` is a gather over a static per-bin window followed by a
`sum` over that window, never an atomic `scatter_add_`.

Tensors follow the input's device.  The static tables are built once with
numpy/scipy and cached per (parameters, device).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from roar_tpu_torch.kernels import pyin_viterbi
from roar_tpu_torch.ops.spectrogram import frame_signal, full_fp32_matmul

_TINY = 1.1754944e-38  # float32 tiny


@dataclasses.dataclass(frozen=True)
class PyinConfig:
    """pYIN parameters; defaults mirror librosa.pyin's signature."""

    sample_rate: int = 22050
    fmin: float = 65.40639132514966  # C2
    fmax: float = 2093.004522404789  # C7
    frame_length: int = 2048
    win_length: Optional[int] = None  # -> frame_length // 2
    hop_length: Optional[int] = None  # -> frame_length // 4
    n_thresholds: int = 100
    beta_a: float = 2.0
    beta_b: float = 18.0
    boltzmann_parameter: float = 2.0
    resolution: float = 0.1
    max_transition_rate: float = 35.92
    switch_prob: float = 0.01
    no_trough_prob: float = 0.01
    fill_na: float = 0.0
    center: bool = True

    @property
    def win(self) -> int:
        return self.win_length or self.frame_length // 2

    @property
    def hop(self) -> int:
        return self.hop_length or self.frame_length // 4

    @property
    def min_period(self) -> int:
        return max(int(math.ceil(self.sample_rate / self.fmax)), 1)

    @property
    def max_period(self) -> int:
        return min(
            int(math.floor(self.sample_rate / self.fmin)),
            self.frame_length - self.win - 1,
        )

    @property
    def n_periods(self) -> int:
        return self.max_period - self.min_period + 1

    @property
    def n_bins_per_semitone(self) -> int:
        return int(math.ceil(1.0 / self.resolution))

    @property
    def n_pitch_bins(self) -> int:
        return (
            int(
                math.floor(
                    12 * self.n_bins_per_semitone * math.log2(self.fmax / self.fmin)
                )
            )
            + 1
        )

    @property
    def max_semitones_per_frame(self) -> int:
        return round(self.max_transition_rate * 12 * self.hop / self.sample_rate)

    @property
    def transition_width(self) -> int:
        return self.max_semitones_per_frame * self.n_bins_per_semitone + 1

    def num_frames(self, num_samples):
        if self.center:
            return num_samples // self.hop + 1
        return (num_samples - self.frame_length) // self.hop + 1

    def freqs(self) -> np.ndarray:
        """Pitch-bin center frequencies [n_pitch_bins]."""
        return self.fmin * 2.0 ** (
            np.arange(self.n_pitch_bins) / (12 * self.n_bins_per_semitone)
        )


# ---------------------------------------------------------------------------
# Static tables (numpy/scipy, as in the JAX package; tests hold them equal)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _beta_probs(n_thresholds: int, a: float, b: float) -> np.ndarray:
    """P(threshold bucket) under Beta(a, b), [n_thresholds]."""
    from scipy.stats import beta as beta_dist

    thresholds = np.linspace(0.0, 1.0, n_thresholds + 1)
    cdf = beta_dist.cdf(thresholds, a, b)
    return np.diff(cdf).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _thresholds(n_thresholds: int) -> np.ndarray:
    """Upper edges of the threshold buckets, float32 [n_thresholds]: i times
    the float32 step, which is how the JAX package's float32 `linspace`
    rounds them (a trough is admitted by `height < edge`, so the edges must
    agree to the bit)."""
    i = np.arange(n_thresholds + 1, dtype=np.float32)
    edges = i * np.float32(1.0 / n_thresholds)
    edges[-1] = 1.0
    return edges[1:]


@functools.lru_cache(maxsize=8)
def _band_tables(n_pitch_bins: int, transition_width: int):
    """(log_tri [W], log_norm [N]) for the banded triangle transition.

    local[i, j] = tri(j - i) / norm(i) for |j - i| <= W//2; the banded
    Viterbi folds -log_norm into the source value and max-convolves with
    log_tri.  tri > 0 at every offset, so log_tri is finite.
    """
    n, width = n_pitch_bins, transition_width
    half = width // 2
    offsets = np.arange(-half, half + 1)
    tri = 1.0 - np.abs(offsets) / float(half + 1)
    norm = np.zeros(n)
    for i in range(n):
        j = i + offsets
        valid = (j >= 0) & (j < n)
        norm[i] = tri[valid].sum()
    return (
        np.log(tri).astype(np.float32),
        np.log(norm).astype(np.float32),
    )


@functools.lru_cache(maxsize=8)
def _transition_matrix(
    n_pitch_bins: int, transition_width: int, switch_prob: float
) -> np.ndarray:
    """[2N, 2N] row-stochastic transition matrix: kron of the 2x2 voicing
    switch with the row-normalized triangle window (the dense form of what
    the banded decode computes; used by tests)."""
    n = n_pitch_bins
    width = transition_width
    local = np.zeros((n, n), dtype=np.float64)
    half = width // 2
    offsets = np.arange(-half, half + 1)
    tri = 1.0 - np.abs(offsets) / float(half + 1)  # triangle window, peak 1
    for i in range(n):
        j = i + offsets
        valid = (j >= 0) & (j < n)
        row = np.zeros(n)
        row[j[valid]] = tri[valid]
        local[i] = row / row.sum()
    switch = np.array(
        [[1.0 - switch_prob, switch_prob], [switch_prob, 1.0 - switch_prob]]
    )
    return np.kron(switch, local).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _bin_period_tables(cfg: PyinConfig):
    """For each pitch bin, the periods that can land in it.

    A period p with a parabolic shift in [-1, 1] reaches the bins
    [lo[p], hi[p]] (one bin of rounding slack either side, as the JAX
    package's `_bin_window_tables`); both bounds fall as p grows, so the
    periods reaching bin b are one contiguous run.  Returns
    (idx [n_bins, V] int64 period indices, clipped into range,
    valid [n_bins, V] bool), V the longest run.
    """
    n_bins = cfg.n_pitch_bins
    p_count = cfg.n_periods
    p_idx = np.arange(p_count, dtype=np.float64)

    def bin_of(periods):
        f0 = cfg.sample_rate / np.maximum(periods, 1e-6)
        b = 12 * cfg.n_bins_per_semitone * np.log2(f0 / cfg.fmin)
        return np.clip(np.round(b), 0, n_bins - 1).astype(np.int64)

    hi = np.minimum(bin_of(cfg.min_period + p_idx - 1.0) + 1, n_bins - 1)
    lo = np.maximum(bin_of(cfg.min_period + p_idx + 1.0) - 1, 0)
    bins = np.arange(n_bins)[:, None]
    reach = (lo[None, :] <= bins) & (bins <= hi[None, :])  # [n_bins, P]
    first = np.where(reach.any(1), reach.argmax(1), 0)
    count = reach.sum(1)
    v = max(int(count.max()), 1)
    idx = first[:, None] + np.arange(v)[None, :]
    valid = np.arange(v)[None, :] < count[:, None]
    return np.minimum(idx, p_count - 1).astype(np.int64), valid


def _threshold_tables(n_thresholds: int, a: float, b: float):
    """(threshold upper edges, bucket probabilities, their running sum)."""
    beta = _beta_probs(n_thresholds, a, b)
    return _thresholds(n_thresholds), beta, np.cumsum(beta, dtype=np.float32)


def _freq_table(cfg: PyinConfig):
    return (cfg.freqs().astype(np.float32),)


@functools.lru_cache(maxsize=32)
def _on_device(table, key: tuple, device: str) -> Tuple[torch.Tensor, ...]:
    """The arrays of the static table `table(*key)` as tensors on `device`,
    built once per (table, key, device)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in table(*key))


# ---------------------------------------------------------------------------
# Framing + CMNDF
# ---------------------------------------------------------------------------


def frame_audio(audio: torch.Tensor, cfg: PyinConfig) -> torch.Tensor:
    """[B, T, frame_length] frames (a view); center pads with zeros
    (librosa's pyin pad_mode='constant'), not by reflection."""
    if cfg.center:
        pad = cfg.frame_length // 2
        audio = F.pad(audio, (pad, pad))
    return frame_signal(audio, cfg.frame_length, cfg.hop)


def cumulative_mean_normalized_difference(
    frames: torch.Tensor, cfg: PyinConfig
) -> torch.Tensor:
    """CMNDF d'(tau) for tau in [min_period, max_period].

    frames: [..., frame_length] -> [..., n_periods].
    Difference function d(tau) = r_t(0) + r_{t+tau}(0) - 2*acf(tau), the
    autocorrelation taken in the frequency domain.
    """
    fl, w = cfg.frame_length, cfg.win
    x = frames.float()
    n_lags = cfg.max_period + 1

    a = torch.fft.rfft(x, n=fl, dim=-1)
    b = torch.fft.rfft(torch.flip(x[..., : w + 1], dims=(-1,)), n=fl, dim=-1)
    acf = torch.fft.irfft(a * b, n=fl, dim=-1)[..., w : w + n_lags]
    acf = torch.where(torch.abs(acf) < 1e-6, 0.0, acf)

    # Rolling window energy: E(tau) = sum_{i=tau+1}^{tau+w} x_i^2
    energy_cum = torch.cumsum(torch.square(x), dim=-1)
    energy = energy_cum[..., w : w + n_lags] - energy_cum[..., :n_lags]
    energy = torch.where(torch.abs(energy) < 1e-6, 0.0, energy)

    d = energy[..., :1] + energy - 2.0 * acf  # [..., n_lags]

    tau = torch.arange(1, cfg.max_period + 1, dtype=torch.float32, device=x.device)
    cum_mean = torch.cumsum(d[..., 1 : cfg.max_period + 1], dim=-1) / tau
    numerator = d[..., cfg.min_period : cfg.max_period + 1]
    denominator = cum_mean[..., cfg.min_period - 1 : cfg.max_period]
    return numerator / (denominator + _TINY)


def parabolic_shifts(yin: torch.Tensor) -> torch.Tensor:
    """Sub-bin shift of each local extremum via parabola vertex; zero at the
    edges, for shifts >1 bin, and where curvature is non-positive."""
    y0 = yin[..., :-2]
    y1 = yin[..., 1:-1]
    y2 = yin[..., 2:]
    a = (y0 + y2 - 2.0 * y1) / 2.0
    b = (y2 - y0) / 2.0
    shift = -b / (2.0 * a + _TINY)
    shift = torch.where(torch.abs(shift) <= 1.0, shift, 0.0)
    return F.pad(shift, (1, 1))


# ---------------------------------------------------------------------------
# Trough priors
# ---------------------------------------------------------------------------


def _boltzmann_pmf(k: torch.Tensor, lam: float, n: torch.Tensor) -> torch.Tensor:
    """Boltzmann (truncated discrete exponential) pmf."""
    n = torch.clamp(n.float(), min=1.0)
    return (
        (1.0 - math.exp(-lam))
        * torch.exp(-lam * k.float())
        / (1.0 - torch.exp(-lam * n))
    )


def _troughs(yin: torch.Tensor) -> torch.Tensor:
    """Local minima along the period axis, as librosa: index 0 is a trough
    iff yin[0] < yin[1]; the last index never is."""
    cur = yin[..., 1:-1]
    interior = (cur < yin[..., :-2]) & (cur <= yin[..., 2:])
    first = yin[..., :1] < yin[..., 1:2]
    return torch.cat([first, interior, torch.zeros_like(first)], dim=-1)


def _global_min_bonus(heights, is_trough, thresholds, beta_cdf, cfg: PyinConfig):
    """(index of the lowest trough [F, 1], no-trough mass it absorbs [F, 1]):
    the mass of the thresholds that admit no trough, times `no_trough_prob`;
    0 for a frame without troughs.  `argmin` takes the first minimum."""
    min_height, global_min = torch.min(heights, dim=-1, keepdim=True)
    # number of thresholds with no trough below them == count(threshold <= h_min)
    n_empty = torch.sum(thresholds <= min_height, dim=-1, keepdim=True)
    empty_mass = torch.where(n_empty > 0, beta_cdf[torch.clamp(n_empty - 1, min=0)], 0.0)
    has_trough = torch.any(is_trough, dim=-1, keepdim=True)
    return global_min, torch.where(has_trough, cfg.no_trough_prob * empty_mass, 0.0)


def trough_probabilities(yin: torch.Tensor, cfg: PyinConfig) -> torch.Tensor:
    """Per-period candidate probabilities, dense [F, n_periods].

    Non-trough positions carry probability 0.  For each of `n_thresholds`
    beta-distributed thresholds, troughs below the threshold are ranked and
    weighted by a Boltzmann distribution over rank; the global minimum
    absorbs `no_trough_prob` of the mass of thresholds that admit no trough.
    Materializes [F, n_periods, n_thresholds]: the test oracle of
    `trough_probabilities_compact`.
    """
    thresholds, beta_probs, beta_cdf = _on_device(
        _threshold_tables, (cfg.n_thresholds, cfg.beta_a, cfg.beta_b), str(yin.device))
    is_trough = _troughs(yin)
    heights = torch.where(is_trough, yin, torch.inf)

    below = is_trough[..., None] & (heights[..., None] < thresholds)  # [F, P, n_thresh]
    rank = torch.cumsum(below, dim=-2) - 1
    n_troughs = torch.sum(below, dim=-2, keepdim=True)
    pmf = _boltzmann_pmf(rank, cfg.boltzmann_parameter, n_troughs)
    pmf = torch.where(below, pmf, 0.0)
    with full_fp32_matmul():
        probs = pmf @ beta_probs

    global_min, bonus = _global_min_bonus(heights, is_trough, thresholds, beta_cdf, cfg)
    return probs.scatter_add_(-1, global_min, bonus)  # one position per frame


def trough_probabilities_compact(
    yin: torch.Tensor, cfg: PyinConfig, max_troughs: int = 128
) -> torch.Tensor:
    """`trough_probabilities` with the period axis compacted to trough slots.

    Only troughs carry probability (typically 20-100 of ~330 periods), so the
    first `max_troughs` troughs are moved into slots in period order, the
    same rank/Boltzmann/threshold arithmetic runs on [F, K, n_thresholds],
    and the result is written back to the period axis.  A trough's slot is
    its rank among troughs, `cumsum(is_trough) - 1`; non-troughs and troughs
    past K go to a dump column that is dropped.  The global-minimum bonus is
    taken over the full period axis, as in the dense version.  yin: [F, P].
    """
    thresholds, beta_probs, beta_cdf = _on_device(
        _threshold_tables, (cfg.n_thresholds, cfg.beta_a, cfg.beta_b), str(yin.device))
    f, p = yin.shape
    k_slots = min(max_troughs, p)
    is_trough = _troughs(yin)
    heights = torch.where(is_trough, yin, torch.inf)

    slot_of = torch.cumsum(is_trough, dim=-1) - 1  # [F, P] rank among troughs
    slot = torch.where(is_trough & (slot_of < k_slots), slot_of, k_slots)
    h_k = yin.new_full((f, k_slots + 1), torch.inf).scatter_(1, slot, yin)[:, :k_slots]
    periods = torch.arange(p, device=yin.device).expand(f, p)
    pos = torch.full((f, k_slots + 1), p, dtype=torch.long, device=yin.device)
    pos = pos.scatter_(1, slot, periods)[:, :k_slots]  # p marks an empty slot

    below = h_k[..., None] < thresholds  # [F, K, n_thresh]; empty slots are +inf
    rank = torch.cumsum(below, dim=-2) - 1
    n_troughs = torch.sum(below, dim=-2, keepdim=True)
    pmf = _boltzmann_pmf(rank, cfg.boltzmann_parameter, n_troughs)
    pmf = torch.where(below, pmf, 0.0)
    with full_fp32_matmul():
        probs_k = pmf @ beta_probs  # [F, K]; 0 for an empty slot

    # slots land on distinct periods; empty slots on the dump column p
    out = yin.new_zeros((f, p + 1)).scatter_(1, pos, probs_k)[:, :p]
    global_min, bonus = _global_min_bonus(heights, is_trough, thresholds, beta_cdf, cfg)
    return out.contiguous().scatter_add_(-1, global_min, bonus)


# ---------------------------------------------------------------------------
# Observations + Viterbi
# ---------------------------------------------------------------------------


def observation_probs(
    probs: torch.Tensor, shifts: torch.Tensor, cfg: PyinConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map period-candidate probabilities to pitch-bin observations.

    probs, shifts: [F, n_periods] (F = flattened frames).
    Returns (obs [F, 2*n_pitch_bins], voiced_prob [F]).

    Several periods add into one pitch bin.  Each bin gathers the run of
    periods that can reach it (`_bin_period_tables`), keeps those whose
    rounded bin is this one, and sums over the run: a fixed order of
    additions, the same in every run.
    """
    f, p = probs.shape
    n_bins = cfg.n_pitch_bins
    device = probs.device
    periods = (
        cfg.min_period + torch.arange(p, dtype=torch.float32, device=device)[None, :] + shifts
    )
    f0 = cfg.sample_rate / torch.clamp(periods, min=1e-6)
    bin_idx = 12 * cfg.n_bins_per_semitone * torch.log2(f0 / cfg.fmin)
    bin_idx = torch.clamp(torch.round(bin_idx), 0, n_bins - 1).to(torch.int32)

    idx, valid = _on_device(_bin_period_tables, (cfg,), str(device))  # [n_bins, V]
    hit = (bin_idx[:, idx] == torch.arange(n_bins, device=device)[:, None]) & valid
    voiced = torch.sum(torch.where(hit, probs[:, idx], 0.0), dim=-1)  # [F, n_bins]
    voiced_prob = torch.clamp(torch.sum(voiced, dim=-1), 0.0, 1.0)
    unvoiced = ((1.0 - voiced_prob) / n_bins)[:, None].expand(f, n_bins)
    return torch.cat([voiced, unvoiced], dim=-1), voiced_prob


def banded_viterbi_decode(log_obs: torch.Tensor, cfg: PyinConfig) -> torch.Tensor:
    """Viterbi decode specialized to pYIN's kron(switch, banded-triangle)
    transition: per step, a width-W max-convolution over pitch bins instead
    of a dense [2N, 2N] max-plus product.

    log_obs: [B, T, 2N] float32.  Returns states [B, T] int32.  On a CUDA
    tensor the forward pass and the backtrack are the two CUDA kernels of
    `kernels/pyin_viterbi.py`, launched back to back on the current stream;
    on a CPU tensor their plain versions.  The first maximum wins every tie.
    """
    n = log_obs.shape[-1] // 2
    log_tri, log_norm = _on_device(_band_tables, (n, cfg.transition_width), str(log_obs.device))
    ptrs, v_final = pyin_viterbi.viterbi_forward(
        log_obs.contiguous(), log_tri, log_norm,
        float(np.log1p(-cfg.switch_prob)), float(np.log(cfg.switch_prob)),
    )
    last = torch.argmax(v_final, dim=-1).to(torch.int32)  # first maximum
    return pyin_viterbi.viterbi_backtrack(ptrs, last)


def viterbi_decode(
    log_obs: torch.Tensor, log_trans: torch.Tensor, log_init: torch.Tensor
) -> torch.Tensor:
    """Dense max-product decoding (test oracle).  log_obs: [B, T, N];
    log_trans: [N, N]; log_init: [N].  Returns states [B, T] int32."""
    t = log_obs.shape[1]
    v = log_init[None, :] + log_obs[:, 0]  # [B, N]
    ptrs = []
    for i in range(1, t):
        # scores[b, i, j] = v[b, i] + log_trans[i, j]
        best, ptr = torch.max(v[:, :, None] + log_trans[None], dim=1)
        ptrs.append(ptr)
        v = best + log_obs[:, i]
    state = torch.argmax(v, dim=-1)
    states = [state]
    for ptr in reversed(ptrs):
        state = torch.gather(ptr, 1, state[:, None])[:, 0]
        states.append(state)
    return torch.stack(states[::-1], dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------


def log_observations(
    yin: torch.Tensor, cfg: PyinConfig, frame_chunk: int = 4096
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CMNDF [B, T, P] -> (log_obs [B, T, 2N], voiced_prob [B, T]).

    Trough priors and observations run over chunks of `frame_chunk` frames,
    which bounds the [chunk, K, n_thresholds] intermediates (about 64 KB a
    frame each at K = 160, 100 thresholds).  K = 160 exceeds the structural
    bound on the trough count (local minima are at least two apart, so at
    most n_periods/3 + 1 interior troughs fit 327 periods), so the
    compaction drops nothing.
    """
    b, t, p = yin.shape
    k_slots = min(160, p)
    flat_yin = yin.reshape(-1, p)
    flat_shifts = parabolic_shifts(yin).reshape(-1, p)
    obs, vprob = [], []
    for i in range(0, flat_yin.shape[0], frame_chunk):
        probs = trough_probabilities_compact(flat_yin[i : i + frame_chunk], cfg, k_slots)
        o, vp = observation_probs(probs, flat_shifts[i : i + frame_chunk], cfg)
        obs.append(o)
        vprob.append(vp)
    obs = torch.cat(obs).reshape(b, t, 2 * cfg.n_pitch_bins)
    # -700 floor for zero-probability entries mirrors float64
    # log(x + tiny) semantics (fp32 tiny would give only -87)
    log_obs = torch.where(obs > 0, torch.log(torch.clamp(obs, min=1e-37)), -700.0)
    return log_obs, torch.cat(vprob).reshape(b, t)


def pyin(
    audio: torch.Tensor,
    audio_lens: torch.Tensor,
    cfg: PyinConfig,
    frame_chunk: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched pYIN on the device `audio` lies on.

    Args:
        audio: [B, S] float32 (padded).
        audio_lens: [B] valid sample counts.
        cfg: parameters.
        frame_chunk: frames per trough-prior step (see `log_observations`).

    Returns:
        f0 [B, T] (fill_na where unvoiced / beyond length),
        voiced_mask [B, T] bool,
        voiced_prob [B, T] float32.
    """
    if audio.dim() == 1:
        audio = audio[None]
    frames = frame_audio(audio.float(), cfg)  # [B, T, fl]
    t = frames.shape[1]
    yin = cumulative_mean_normalized_difference(frames, cfg)  # [B, T, P]
    log_obs, voiced_prob = log_observations(yin, cfg, frame_chunk)
    states = banded_viterbi_decode(log_obs, cfg).long()  # [B, T]

    (freqs,) = _on_device(_freq_table, (cfg,), str(audio.device))
    f0 = freqs[states % cfg.n_pitch_bins]
    voiced = states < cfg.n_pitch_bins

    # Every row is decoded over all T frames; frames beyond each utterance's
    # valid frame count are masked afterwards.
    n_frames = cfg.num_frames(audio_lens.to(audio.device))
    valid = torch.arange(t, device=audio.device)[None, :] < n_frames[:, None]
    voiced = voiced & valid
    f0 = torch.where(voiced, f0, cfg.fill_na)
    voiced_prob = torch.where(valid, voiced_prob, 0.0)
    return f0, voiced, voiced_prob
