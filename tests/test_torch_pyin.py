"""pYIN of the port against the JAX package, stage by stage and end to end.

Thresholds make pYIN discontinuous (`|acf| < 1e-6 -> 0`, troughs by `<`,
`height < threshold`, `round` to a pitch bin), and the port's FFT
autocorrelation differs from the JAX package's DFT product in the last bits.
So every stage is held to the JAX function GIVEN THE JAX STAGE'S INPUT, the
static tables and the Viterbi decodes are held bit for bit, and the whole
pipeline is held statistically.  jax is imported inside the tests, so that
the `cuda`-marked tests run where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pyin.py -m cuda
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from roar_tpu_torch.kernels import pyin_viterbi as pv
from roar_tpu_torch.ops import pyin as tp
from roar_tpu_torch.ops.pyin_reference import pyin_cpu

SMALL_KW = dict(sample_rate=8000, fmin=80.0, fmax=400.0, frame_length=512)
SMALL = tp.PyinConfig(**SMALL_KW)  # N = 279 pitch bins, W = 71, 81 periods
DEFAULT = tp.PyinConfig()          # N = 601, W = 101, 327 periods
FIXTURES = Path(__file__).parent / "fixtures" / "pyin_golden.npz"


def _jax_cfg(cfg):
    from roar_tpu.ops.pyin import PyinConfig

    return PyinConfig(sample_rate=cfg.sample_rate, fmin=cfg.fmin, fmax=cfg.fmax,
                      frame_length=cfg.frame_length)


def _audio(cfg, seed=0, seconds=0.75):
    """Three rows: a tone with vibrato, noise, silence then a tone."""
    rng = np.random.default_rng(seed)
    n = int(cfg.sample_rate * seconds)
    t = np.arange(n) / cfg.sample_rate
    vib = 0.5 * np.sin(2 * np.pi * 150.0 * t + 3.0 * np.sin(2 * np.pi * 5.0 * t))
    noise = 0.3 * rng.standard_normal(n)
    late = np.concatenate([np.zeros(n // 3), 0.4 * np.sin(2 * np.pi * 220.0 * t[: n - n // 3])])
    late += 0.01 * rng.standard_normal(n)
    return np.stack([vib, noise, late]).astype(np.float32)


def _jax_yin(cfg, seed=0):
    """The JAX package's CMNDF rows [F, P] for `_audio`: the input every
    later stage of both packages is fed."""
    import jax.numpy as jnp

    from roar_tpu.ops import pyin as jp

    jcfg = _jax_cfg(cfg)
    frames = jp.frame_audio(jnp.asarray(_audio(cfg, seed)), jcfg)
    yin = np.asarray(jp.cumulative_mean_normalized_difference(frames, jcfg))
    return np.ascontiguousarray(yin.reshape(-1, yin.shape[-1]))


def _log_obs(rng, b, t, n):
    """Seeded log observations, as tests/test_pyin.py builds them."""
    obs = rng.random((b, t, 2 * n)).astype(np.float32)
    obs /= obs.sum(-1, keepdims=True)
    return np.where(obs > 0, np.log(np.maximum(obs, 1e-37)), -700.0).astype(np.float32)


# ---------------------------------------------------------------------------
# Static tables: bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [SMALL, DEFAULT], ids=["small", "default"])
def test_config_derived_sizes_match_jax(cfg):
    jcfg = _jax_cfg(cfg)
    for name in ("win", "hop", "min_period", "max_period", "n_periods", "n_bins_per_semitone",
                 "n_pitch_bins", "max_semitones_per_frame", "transition_width"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    np.testing.assert_array_equal(cfg.freqs(), jcfg.freqs())
    for n in (0, 511, 512, 220500):
        assert cfg.num_frames(n) == jcfg.num_frames(n)
    lens = np.array([4321, 100, 16384])
    np.testing.assert_array_equal(cfg.num_frames(torch.from_numpy(lens)).numpy(),
                                  jcfg.num_frames(lens))


def test_default_config_is_the_production_shape():
    assert (DEFAULT.n_pitch_bins, DEFAULT.transition_width, DEFAULT.n_periods, DEFAULT.hop) \
        == (601, 101, 327, 512)
    assert DEFAULT.num_frames(229376) == 449  # 10 s padded to a multiple of 16384


def test_beta_probs_bit_identical():
    from roar_tpu.ops import pyin as jp

    for n, a, b in ((100, 2.0, 18.0), (50, 1.5, 10.0)):
        np.testing.assert_array_equal(tp._beta_probs(n, a, b), jp._beta_probs(n, a, b))


@pytest.mark.parametrize("n", [100, 50, 37])
def test_thresholds_are_the_jax_float32_linspace(n):
    import jax.numpy as jnp

    want = np.asarray(jnp.linspace(0.0, 1.0, n + 1)[1:])
    np.testing.assert_array_equal(tp._thresholds(n), want)


@pytest.mark.parametrize("n,w", [(279, 71), (601, 101), (30, 11)])
def test_band_tables_bit_identical_and_finite(n, w):
    from roar_tpu.ops import pyin as jp

    log_tri, log_norm = tp._band_tables(n, w)
    want_tri, want_norm = jp._band_tables(n, w)
    np.testing.assert_array_equal(log_tri, want_tri)
    np.testing.assert_array_equal(log_norm, want_norm)
    # the triangle is positive at every offset, so no -inf enters the kernel
    assert np.isfinite(log_tri).all() and np.isfinite(log_norm).all()
    assert log_tri.shape == (w,) and log_norm.shape == (n,)


def test_transition_matrix_bit_identical():
    from roar_tpu.ops import pyin as jp

    np.testing.assert_array_equal(tp._transition_matrix(30, 11, 0.01),
                                  jp._transition_matrix(30, 11, 0.01))
    np.testing.assert_array_equal(tp._transition_matrix(279, 71, 0.01),
                                  jp._transition_matrix(279, 71, 0.01))


@pytest.mark.parametrize("cfg", [SMALL, DEFAULT], ids=["small", "default"])
def test_bin_period_table_covers_the_jax_windows(cfg):
    """Every (period, bin) pair that a shift in [-1, 1] can produce lies in
    the JAX package's static bin window and in the port's per-bin period
    run, and each run is contiguous."""
    from roar_tpu.ops import pyin as jp

    lo, width, _ = jp._bin_window_tables(_jax_cfg(cfg))
    idx, valid = tp._bin_period_tables(cfg)
    n_bins, p = cfg.n_pitch_bins, cfg.n_periods
    want = np.zeros((n_bins, p), bool)
    # the JAX window is [lo, lo + width); the port keeps its tight form
    # [lo, hi], which every reachable bin lies in (checked below by shifts)
    reach = np.zeros((n_bins, p), bool)
    for b in range(n_bins):
        reach[b, idx[b][valid[b]]] = True
    for shift in (-1.0, -0.5, 0.0, 0.5, 1.0):
        periods = cfg.min_period + np.arange(p) + shift
        f0 = cfg.sample_rate / np.maximum(periods, 1e-6)
        bins = np.clip(np.round(12 * cfg.n_bins_per_semitone * np.log2(f0 / cfg.fmin)),
                       0, n_bins - 1).astype(int)
        want[bins, np.arange(p)] = True
        assert ((bins - lo >= 0) & (bins - lo < width)).all()
    assert (reach | ~want).all()  # every reachable pair is gathered
    assert (valid.sum(1) == reach.sum(1)).all()  # runs are contiguous, no duplicate


# ---------------------------------------------------------------------------
# Stages, each fed the JAX stage's input
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [SMALL, DEFAULT], ids=["small", "default"])
def test_frame_audio_equal(cfg):
    import jax.numpy as jnp

    from roar_tpu.ops import pyin as jp

    x = _audio(cfg, seconds=0.4)
    want = np.asarray(jp.frame_audio(jnp.asarray(x), _jax_cfg(cfg)))
    got = tp.frame_audio(torch.from_numpy(x), cfg).numpy()
    np.testing.assert_array_equal(got, want)  # zero pad, then a pure gather


@pytest.mark.parametrize("cfg", [SMALL, DEFAULT], ids=["small", "default"])
def test_cmndf_matches_jax(cfg):
    import jax.numpy as jnp

    from roar_tpu.ops import pyin as jp

    x = _audio(cfg, seconds=0.4)
    jcfg = _jax_cfg(cfg)
    frames = jp.frame_audio(jnp.asarray(x), jcfg)
    want = np.asarray(jp.cumulative_mean_normalized_difference(frames, jcfg))
    got = tp.cumulative_mean_normalized_difference(
        torch.from_numpy(np.asarray(frames)), cfg).numpy()
    assert got.shape == want.shape == (3, frames.shape[1], cfg.n_periods)
    # FFT against DFT product: the bar tests/test_pyin.py holds the JAX
    # package's own two formulations to (test_matmul_cmndf_matches_fft);
    # measured max |diff| 1.1e-6 (small) and 3.0e-5 (default) on values up to 9
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)


def test_cmndf_of_silence_is_zero():
    frames = torch.zeros(2, 3, SMALL.frame_length)
    yin = tp.cumulative_mean_normalized_difference(frames, SMALL)
    assert torch.equal(yin, torch.zeros(2, 3, SMALL.n_periods))


def test_parabolic_shifts_equal_given_jax_input():
    import jax.numpy as jnp

    from roar_tpu.ops import pyin as jp

    yin = _jax_yin(SMALL)
    want = np.asarray(jp.parabolic_shifts(jnp.asarray(yin)))
    got = tp.parabolic_shifts(torch.from_numpy(yin)).numpy()
    # the same five float32 operations per element; measured 0
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
    assert (np.abs(got) <= 1.0).all() and (got[:, 0] == 0).all() and (got[:, -1] == 0).all()


@pytest.mark.parametrize("cfg,max_troughs", [(SMALL, 160), (DEFAULT, 160), (DEFAULT, 24)],
                         ids=["small", "default", "default-k24"])
def test_trough_probabilities_compact_matches_jax_and_dense(cfg, max_troughs):
    import jax.numpy as jnp

    from roar_tpu.ops import pyin as jp

    yin = _jax_yin(cfg)[:96]
    want = np.asarray(jp.trough_probabilities_compact(jnp.asarray(yin), _jax_cfg(cfg), max_troughs))
    got = tp.trough_probabilities_compact(torch.from_numpy(yin), cfg, max_troughs).numpy()
    # probabilities in [0, 1]: a 100-term float32 dot product in another
    # order; measured max |diff| 6e-8
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert ((got > 0) <= tp._troughs(torch.from_numpy(yin)).numpy()).all()
    if max_troughs >= cfg.n_periods // 3 + 2:  # nothing dropped: equal to the dense form
        dense = tp.trough_probabilities(torch.from_numpy(yin), cfg).numpy()
        np.testing.assert_allclose(got, dense, atol=1e-6, rtol=0)
        jdense = np.asarray(jp.trough_probabilities(jnp.asarray(yin), _jax_cfg(cfg)))
        np.testing.assert_allclose(dense, jdense, atol=1e-6, rtol=0)


def test_trough_probabilities_edge_rows():
    """No trough at all; ties in the minimum (the first one takes the
    bonus); a trough at index 0."""
    p = SMALL.n_periods
    rising = torch.linspace(0.5, 1.5, p)[None].flip(-1)          # falling: no trough
    flat = torch.full((1, p), 0.8)
    flat[0, 10] = flat[0, 30] = 0.5                               # two equal minima
    first = torch.linspace(0.05, 2.0, p)[None]                    # trough at index 0
    yin = torch.cat([rising, flat, first])
    got = tp.trough_probabilities_compact(yin, SMALL, 160)
    dense = tp.trough_probabilities(yin, SMALL)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-6, rtol=0)
    assert got[0].sum() == 0
    assert set(torch.nonzero(got[1])[:, 0].tolist()) == {10, 30} and got[1, 10] > got[1, 30]
    assert torch.nonzero(got[2])[:, 0].tolist() == [0]


@pytest.mark.parametrize("cfg", [SMALL, DEFAULT], ids=["small", "default"])
def test_observation_probs_match_jax_given_jax_input(cfg):
    import jax.numpy as jnp

    from roar_tpu.ops import pyin as jp

    yin = _jax_yin(cfg, seed=1)[:96]
    jcfg = _jax_cfg(cfg)
    shifts = np.asarray(jp.parabolic_shifts(jnp.asarray(yin)))
    probs = np.asarray(jp.trough_probabilities_compact(jnp.asarray(yin), jcfg, 160))
    want_obs, want_vp = jp.observation_probs(jnp.asarray(probs), jnp.asarray(shifts), jcfg)
    got_obs, got_vp = tp.observation_probs(torch.from_numpy(probs), torch.from_numpy(shifts), cfg)
    assert got_obs.shape == (96, 2 * cfg.n_pitch_bins)
    # sums of a few probabilities per bin in another order; a period whose
    # float32 log2 lands within an ulp of a .5 boundary could move one bin,
    # which these inputs do not do (measured max |diff| 1.2e-10)
    np.testing.assert_allclose(got_obs.numpy(), np.asarray(want_obs), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_vp.numpy(), np.asarray(want_vp), atol=1e-6, rtol=0)
    # dense accumulation (several periods into one bin) against a scatter
    dense = np.exp(-np.clip(yin, 0.0, 10.0)).astype(np.float32)
    obs, _ = tp.observation_probs(torch.from_numpy(dense), torch.from_numpy(shifts), cfg)
    jobs, _ = jp.observation_probs(jnp.asarray(dense), jnp.asarray(shifts), jcfg)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=2e-6, rtol=0)  # measured 1.2e-7


def test_log_observations_chunking_changes_nothing():
    yin = torch.from_numpy(_jax_yin(SMALL)).reshape(3, -1, SMALL.n_periods)
    whole, vp_whole = tp.log_observations(yin, SMALL, frame_chunk=4096)
    pieces, vp_pieces = tp.log_observations(yin, SMALL, frame_chunk=7)
    assert torch.equal(whole, pieces) and torch.equal(vp_whole, vp_pieces)
    assert whole.shape == (3, yin.shape[1], 2 * SMALL.n_pitch_bins)
    assert whole.min() == -700.0 and torch.isfinite(whole).all()


# ---------------------------------------------------------------------------
# K1 / K2 plain versions: decodes bit-identical to the JAX package
# ---------------------------------------------------------------------------


def _ragged_ties(log_obs):
    """Exact ties: one row constant over states and frames, one row
    repeating its first frame, one frame of another row constant."""
    log_obs = log_obs.copy()
    log_obs[0] = np.float32(np.log(1.0 / log_obs.shape[-1]))
    if log_obs.shape[0] > 1:
        log_obs[1] = log_obs[1, :1]
    if log_obs.shape[0] > 2 and log_obs.shape[1] > 3:
        log_obs[2, 3] = -3.0
    return log_obs


@pytest.mark.parametrize("cfg,b,t,ties", [
    (SMALL, 2, 18, False), (SMALL, 3, 14, True), (DEFAULT, 2, 6, False), (DEFAULT, 3, 5, True),
    (SMALL, 1, 2, False), (SMALL, 1, 1, False),
], ids=["small", "small-ties", "n601", "n601-ties", "t2", "t1"])
def test_banded_decode_equals_jax_scan(cfg, b, t, ties):
    import jax.numpy as jnp

    from roar_tpu.ops.pyin import banded_viterbi_decode

    log_obs = _log_obs(np.random.default_rng(11), b, t, cfg.n_pitch_bins)
    if ties:
        log_obs = _ragged_ties(log_obs)
    want = np.asarray(banded_viterbi_decode(jnp.asarray(log_obs), _jax_cfg(cfg)))
    before = (pv.LAUNCHES_FWD, pv.LAUNCHES_BACKTRACK)
    got = tp.banded_viterbi_decode(torch.from_numpy(log_obs), cfg)
    assert got.dtype == torch.int32 and got.shape == (b, t)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (pv.LAUNCHES_FWD, pv.LAUNCHES_BACKTRACK) == before  # a CPU tensor never launches


def test_banded_decode_equals_pallas_interpret():
    """The size tests/test_pyin.py runs the Pallas kernels at, in interpret
    mode: states from both kernels, then K1's pointers and final scores on
    the valid columns."""
    import jax.numpy as jnp

    from roar_tpu.ops.pyin import _band_tables
    from roar_tpu.ops.pyin_pallas import _viterbi_pallas_call, banded_viterbi_decode_pallas

    cfg, jcfg = SMALL, _jax_cfg(SMALL)
    n, w = cfg.n_pitch_bins, cfg.transition_width
    b, t = 2, 14
    log_obs = _log_obs(np.random.default_rng(11), b, t, n)
    want = np.asarray(banded_viterbi_decode_pallas(jnp.asarray(log_obs), jcfg, interpret=True))
    np.testing.assert_array_equal(tp.banded_viterbi_decode(torch.from_numpy(log_obs), cfg).numpy(),
                                  want)

    # K1 alone, in the TPU layout: [T, B, 2, NP], lanes padded to 128 with
    # -1e30, batch padded to 8 sublanes
    bp, np_ = 8, 384
    obs = np.full((t, bp, 2, np_), -1e30, np.float32)
    obs[:, :b, :, :n] = log_obs.transpose(1, 0, 2).reshape(t, b, 2, n)
    obs[:, b:, :, :n] = 0.0
    log_tri, log_norm = _band_tables(n, w)
    norm = np.zeros((1, np_), np.float32)
    norm[0, :n] = log_norm
    log_stay, log_switch = float(np.log1p(-cfg.switch_prob)), float(np.log(cfg.switch_prob))
    ptrs, v_final = _viterbi_pallas_call(
        jnp.asarray(obs), jnp.asarray(norm), log_tri=tuple(float(x) for x in log_tri), n=n,
        width=w, log_stay=log_stay, log_switch=log_switch, log_init_u=float(np.log(1.0 / n)),
        interpret=True)
    got_ptrs, got_final = pv.viterbi_forward_plain(
        torch.from_numpy(log_obs), torch.from_numpy(log_tri), torch.from_numpy(log_norm),
        log_stay, log_switch)
    want_ptrs = np.asarray(ptrs)[1:, :b, :, :n].reshape(t - 1, b, 2 * n).transpose(1, 0, 2)
    np.testing.assert_array_equal(got_ptrs.numpy()[:, 1:], want_ptrs)  # row 0 is unused
    assert (got_ptrs[:, 0] == 0).all()
    want_final = np.asarray(v_final)[:b, :, :n].reshape(b, 2 * n)
    np.testing.assert_array_equal(got_final.numpy(), want_final)


def test_plain_backtrack_follows_pointers():
    rng = np.random.default_rng(3)
    b, t, s = 4, 9, 12
    ptrs = torch.from_numpy(rng.integers(0, s, (b, t, s)).astype(np.int32))
    last = torch.from_numpy(rng.integers(0, s, b).astype(np.int32))
    got = pv.viterbi_backtrack(ptrs, last).numpy()
    for i in range(b):
        state = int(last[i])
        for j in range(t - 1, -1, -1):
            assert got[i, j] == state
            state = int(ptrs[i, j, state])
    assert pv.viterbi_backtrack(ptrs[:, :1], last).numpy().tolist() == last[:, None].tolist()


def test_banded_decode_matches_dense_viterbi():
    """Banded decode == dense decode with the explicit transition matrix, as
    tests/test_pyin.py holds the JAX pair (identical up to float ties); and
    the port's dense decode equals the JAX package's."""
    import jax.numpy as jnp

    from roar_tpu.ops.pyin import viterbi_decode

    cfg = SMALL
    n = cfg.n_pitch_bins
    log_obs = _log_obs(np.random.default_rng(7), 2, 18, n)
    got = tp.banded_viterbi_decode(torch.from_numpy(log_obs), cfg).numpy()
    trans = tp._transition_matrix(n, cfg.transition_width, cfg.switch_prob)
    log_trans = np.where(trans > 0, np.log(np.maximum(trans, 1e-37)), -1e30).astype(np.float32)
    init = np.full(2 * n, -1e30, np.float32)
    init[n:] = np.log(1.0 / n)
    dense = tp.viterbi_decode(torch.from_numpy(log_obs), torch.from_numpy(log_trans),
                              torch.from_numpy(init)).numpy()
    assert (got == dense).mean() > 0.98
    jdense = np.asarray(viterbi_decode(jnp.asarray(log_obs), jnp.asarray(log_trans),
                                       jnp.asarray(init)))
    np.testing.assert_array_equal(dense, jdense)


def test_dense_viterbi_matches_bruteforce():
    rng = np.random.default_rng(4)
    b, t, n = 2, 12, 7
    log_obs = np.log(rng.random((b, t, n)).astype(np.float32) + 1e-3)
    trans = rng.random((n, n)) + 1e-3
    log_trans = np.log((trans / trans.sum(1, keepdims=True)).astype(np.float32))
    log_init = np.log((np.full(n, 1.0 / n)).astype(np.float32))
    got = tp.viterbi_decode(*(torch.from_numpy(a) for a in (log_obs, log_trans, log_init))).numpy()
    for bi in range(b):
        v = log_init + log_obs[bi, 0]
        ptr = np.zeros((t, n), np.int64)
        for ti in range(1, t):
            scores = v[:, None] + log_trans
            ptr[ti] = scores.argmax(0)
            v = scores.max(0) + log_obs[bi, ti]
        ref = np.zeros(t, np.int64)
        ref[-1] = v.argmax()
        for ti in range(t - 1, 0, -1):
            ref[ti - 1] = ptr[ti, ref[ti]]
        np.testing.assert_array_equal(got[bi], ref)


def test_wrappers_reject_what_the_kernels_do_not_take():
    log_obs = torch.zeros(1, 3, 8, device="meta")
    tri, norm = torch.zeros(3, device="meta"), torch.zeros(4, device="meta")
    with pytest.raises(ValueError):
        pv.viterbi_forward(log_obs, tri, norm, -0.01, -4.6)  # neither CPU nor CUDA
    with pytest.raises(ValueError):
        pv.viterbi_backtrack(torch.zeros(1, 3, 8, dtype=torch.int32, device="meta"),
                             torch.zeros(1, dtype=torch.int32, device="meta"))


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------


def test_pyin_end_to_end_against_jax_ragged():
    """Voicing agreement >= 0.99, and F0 within one pitch bin (10 cents) on
    >= 0.99 of the frames both call voiced.  Measured: 1.0 and 1.0."""
    import jax.numpy as jnp

    from roar_tpu.ops.pyin import pyin as jax_pyin

    x = _audio(SMALL, seed=2)
    lens = np.array([6000, 5000, 4321], np.int32)
    want_f0, want_v, want_p = (np.asarray(a) for a in
                               jax_pyin(jnp.asarray(x), jnp.asarray(lens), _jax_cfg(SMALL)))
    f0, voiced, vprob = (a.numpy() for a in
                         tp.pyin(torch.from_numpy(x), torch.from_numpy(lens), SMALL))
    assert f0.shape == want_f0.shape and voiced.dtype == bool and vprob.dtype == np.float32
    assert (voiced == want_v).mean() >= 0.99
    both = voiced & want_v
    assert both.sum() > 30
    cents = np.abs(1200.0 * np.log2(f0[both] / want_f0[both]))
    assert (cents <= 10.0 + 1e-3).mean() >= 0.99
    np.testing.assert_allclose(vprob, want_p, atol=1e-5)  # measured 1.2e-7
    # frames beyond each utterance are masked
    for j, n in enumerate(SMALL.num_frames(lens)):
        assert not voiced[j, n:].any() and (vprob[j, n:] == 0).all() and (f0[j, n:] == 0).all()


def test_pyin_takes_one_utterance_and_tracks_a_sine():
    t = np.arange(4000) / 8000.0
    x = (0.5 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    f0, voiced, _ = tp.pyin(torch.from_numpy(x), torch.tensor([4000]), SMALL)
    f0, voiced = f0.numpy()[0], voiced.numpy()[0]
    inner = slice(4, len(f0) - 4)
    assert voiced[inner].mean() > 0.95
    assert np.median(np.abs(f0[inner][voiced[inner]] - 220.0) / 220.0) < 0.01
    silent, voiced0, _ = tp.pyin(torch.zeros(1, 4000), torch.tensor([4000]), SMALL)
    assert not voiced0.any() and (silent == SMALL.fill_na).all()


# clip -> (min voicing agreement, max voiced-F0 cents RMSE, max gross-error
# rate at >100 cents): the bars of tests/test_pyin.py GOLDEN_TOLERANCES
GOLDEN_TOLERANCES = {
    "mixed": (0.95, 10.0, 0.02),
    "octave_bait": (0.95, 10.0, 0.02),
    "sweep": (0.95, 50.0, 0.02),
    "vibrato": (0.95, 50.0, 0.02),
}


def _score_golden(name, f0, voiced, z):
    truth_f0, truth_v, sc = z[f"{name}_f0"], z[f"{name}_voiced"], z[f"{name}_score"]
    n = len(truth_f0)
    f0, voiced = np.asarray(f0)[:n], np.asarray(voiced)[:n]
    agree = float((voiced[sc] == truth_v[sc]).mean())
    both = sc & truth_v & voiced & (f0 > 0)
    assert both.any(), f"{name}: no scoreable voiced frames"
    cents = 1200.0 * np.log2(f0[both] / truth_f0[both])
    min_agree, max_rmse, max_gross = GOLDEN_TOLERANCES[name]
    assert agree >= min_agree, f"{name}: voicing agreement {agree:.3f}"
    assert float(np.sqrt(np.mean(cents ** 2))) <= max_rmse, name
    assert float((np.abs(cents) > 100.0).mean()) <= max_gross, name


def test_pyin_golden_fixtures():
    """The port's pyin against the synthesis-truth fixtures (production
    22.05 kHz config); one batched call scores all four clips."""
    z = np.load(FIXTURES)
    cfg = tp.PyinConfig(sample_rate=int(z["sample_rate"]), frame_length=int(z["frame_length"]))
    names = [str(n) for n in z["names"]]
    lens = [len(z[f"{n}_audio"]) for n in names]
    buf = np.zeros((len(names), -(-max(lens) // 4096) * 4096), np.float32)
    for i, n in enumerate(names):
        buf[i, : lens[i]] = z[f"{n}_audio"]
    f0, voiced, _ = tp.pyin(torch.from_numpy(buf), torch.tensor(lens), cfg)
    for i, n in enumerate(names):
        _score_golden(n, f0[i].numpy(), voiced[i].numpy(), z)


@pytest.mark.parametrize("name", sorted(GOLDEN_TOLERANCES))
def test_pyin_cpu_golden_fixtures(name):
    """The port's numpy reference clears the same synthesis-truth bars."""
    z = np.load(FIXTURES)
    cfg = tp.PyinConfig(sample_rate=int(z["sample_rate"]), frame_length=int(z["frame_length"]))
    f0, voiced, _ = pyin_cpu(z[f"{name}_audio"], cfg)
    _score_golden(name, f0, voiced, z)


def test_pyin_cpu_equals_the_jax_packages_copy():
    from roar_tpu.ops.pyin_reference import pyin_cpu as jax_pkg_pyin_cpu

    x = _audio(SMALL, seed=5)[2]
    want = jax_pkg_pyin_cpu(x, _jax_cfg(SMALL))
    got = pyin_cpu(x, SMALL)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,n,w", [(16, 449, 601, 101), (3, 14, 279, 71), (1, 2, 601, 101),
                                     (1, 1, 601, 101)])
def test_cuda_viterbi_kernels_equal_plain(b, t, n, w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    log_obs = torch.from_numpy(_ragged_ties(_log_obs(np.random.default_rng(0), b, t, n))).cuda()
    log_tri, log_norm = (torch.from_numpy(a).cuda() for a in tp._band_tables(n, w))
    args = (log_obs, log_tri, log_norm, float(np.log1p(-0.01)), float(np.log(0.01)))
    before = (pv.LAUNCHES_FWD, pv.LAUNCHES_BACKTRACK)
    ptrs, v_final = pv.viterbi_forward(*args)
    last = torch.argmax(v_final, dim=-1).to(torch.int32)
    states = pv.viterbi_backtrack(ptrs, last)
    torch.cuda.synchronize()
    assert (pv.LAUNCHES_FWD, pv.LAUNCHES_BACKTRACK) == (before[0] + 1, before[1] + 1)
    want_ptrs, want_final = pv.viterbi_forward_plain(*args)
    # additions and comparisons only, in one order: equality is the bar
    assert torch.equal(ptrs, want_ptrs) and torch.equal(v_final, want_final)
    assert torch.equal(states, pv.viterbi_backtrack_plain(ptrs, last))


@pytest.mark.cuda
def test_cuda_pyin_agrees_with_cpu_pyin():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    x = torch.from_numpy(_audio(DEFAULT, seed=2, seconds=1.0))
    lens = torch.tensor([22050, 20000, 15000])
    f0_c, v_c, _ = tp.pyin(x, lens, DEFAULT)
    f0_g, v_g, _ = tp.pyin(x.cuda(), lens.cuda(), DEFAULT)
    # cuFFT and the CPU FFT differ in the last bits, so a few frames may flip
    assert (v_c == v_g.cpu()).float().mean() >= 0.99
    with pytest.raises(ValueError):  # a CUDA tensor launches the kernel or raises
        pv.viterbi_forward(torch.zeros(1, 2, 2 * 1025, device="cuda"),
                           torch.zeros(3, device="cuda"), torch.zeros(1025, device="cuda"), 0., 0.)
