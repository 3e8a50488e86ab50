"""FastPitch text->mel, inference half.

Port of roar_tpu/models/fastpitch.py: `ConvReLUNorm`, `TemporalPredictor`,
`FFTConfig`, `PredictorConfig` and `FastPitchModule.infer` (fastpitch.py:403-456):
encoder FFT -> duration and pitch (and energy) predictors -> pitch/energy
embeddings -> length regulation into a caller-chosen decoder bucket ->
decoder FFT -> mel projection.  The aligner, GST and the training forward are
not ported yet; the weight converter skips a checkpoint's aligner weights.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from roar_tpu_torch.models.submodules import ConditionalInput, ConditionalLayerNorm
from roar_tpu_torch.models.transformer import (
    FFTransformerDecoder,
    FFTransformerEncoder,
    conv1d_btc,
)
from roar_tpu_torch.ops.lengths import log_to_duration, mask_from_lens, regulate_len


class ConvReLUNorm(nn.Module):
    """Conv1d -> ReLU -> ConditionalLayerNorm over [B, T, C]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 condition_dim: int = 384, condition_types: Sequence[str] = ()):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size, padding="same")
        self.norm = ConditionalLayerNorm(out_channels, condition_dim, condition_types)

    def forward(self, x, conditioning=None):
        return self.norm(F.relu(conv1d_btc(self.conv, x)), conditioning)


class TemporalPredictor(nn.Module):
    """Predicts one float per time step."""

    def __init__(self, input_size: int, filter_size: int, kernel_size: int,
                 n_layers: int = 2, condition_types: Sequence[str] = ()):
        super().__init__()
        self.cond_input = ConditionalInput(input_size, input_size, condition_types)
        self.layers = nn.ModuleList(
            ConvReLUNorm(input_size if i == 0 else filter_size, filter_size, kernel_size,
                         condition_dim=input_size, condition_types=condition_types)
            for i in range(n_layers))
        self.fc = nn.Linear(filter_size, 1)

    def forward(self, enc, enc_mask, conditioning=None):
        # enc: [B, T, C]; enc_mask: [B, T, 1]
        x = self.cond_input(enc, conditioning) * enc_mask
        for layer in self.layers:
            x = layer(x, conditioning)
        return (self.fc(x) * enc_mask)[..., 0]


@dataclasses.dataclass(frozen=True)
class FFTConfig:
    """One FFT stack's hyperparameters (fastpitch_22050_align.yaml:155-181)."""

    n_layer: int = 6
    n_head: int = 1
    d_model: int = 384
    d_head: int = 64
    d_inner: int = 1536
    kernel_size: int = 3
    pre_lnorm: bool = False
    condition_types: Sequence[str] = ()
    use_rope: bool = False
    use_flash: bool = False


@dataclasses.dataclass(frozen=True)
class PredictorConfig:
    input_size: int = 384
    kernel_size: int = 3
    filter_size: int = 256
    n_layers: int = 2
    condition_types: Sequence[str] = ()


def _predictor(cfg: PredictorConfig) -> TemporalPredictor:
    return TemporalPredictor(cfg.input_size, cfg.filter_size, cfg.kernel_size,
                             cfg.n_layers, cfg.condition_types)


class FastPitchModule(nn.Module):
    """The FastPitch graph, inference path."""

    def __init__(self, n_symbols: int, padding_idx: int = 0,
                 encoder: FFTConfig = FFTConfig(), decoder: FFTConfig = FFTConfig(),
                 duration_predictor: PredictorConfig = PredictorConfig(),
                 pitch_predictor: PredictorConfig = PredictorConfig(),
                 energy_predictor: Optional[PredictorConfig] = None,
                 n_speakers: int = 1, symbols_embedding_dim: int = 384,
                 pitch_embedding_kernel_size: int = 3,
                 energy_embedding_kernel_size: int = 3, n_mel_channels: int = 80,
                 min_token_duration: int = 0, max_token_duration: int = 75,
                 speaker_emb_condition_prosody: bool = False,
                 speaker_emb_condition_decoder: bool = False):
        super().__init__()
        d = symbols_embedding_dim
        self.n_speakers = n_speakers
        self.min_token_duration = min_token_duration
        self.max_token_duration = max_token_duration
        self.condition_prosody = speaker_emb_condition_prosody
        self.condition_decoder = speaker_emb_condition_decoder
        e = encoder
        self.encoder_module = FFTransformerEncoder(
            e.n_layer, e.n_head, e.d_model, e.d_head, e.d_inner, e.kernel_size,
            n_embed=n_symbols, d_embed=d, padding_idx=padding_idx,
            pre_lnorm=e.pre_lnorm, condition_types=e.condition_types,
            use_rope=e.use_rope, use_flash=e.use_flash)
        o = decoder
        self.decoder_module = FFTransformerDecoder(
            o.n_layer, o.n_head, o.d_model, o.d_head, o.d_inner, o.kernel_size,
            o.pre_lnorm, o.condition_types, o.use_rope, o.use_flash)
        self.duration_predictor_module = _predictor(duration_predictor)
        self.pitch_predictor_module = _predictor(pitch_predictor)
        self.energy_predictor_module = _predictor(energy_predictor) if energy_predictor else None
        if n_speakers > 1:
            self.speaker_table = nn.Embedding(n_speakers, d)
        self.pitch_emb = nn.Conv1d(1, d, pitch_embedding_kernel_size, padding="same")
        if energy_predictor is not None:
            self.energy_emb = nn.Conv1d(1, d, energy_embedding_kernel_size, padding="same")
        self.proj = nn.Linear(decoder.d_model, n_mel_channels)

    def get_speaker_embedding(self, speaker):
        if self.n_speakers > 1 and speaker is not None:
            return self.speaker_table(speaker)[:, None, :]  # [B, 1, D]
        return None

    def infer(self, text: torch.Tensor, pitch: Optional[torch.Tensor] = None,
              speaker: Optional[torch.Tensor] = None,
              energy: Optional[torch.Tensor] = None, pace: float = 1.0,
              max_mel_len: int = 2048) -> Dict[str, torch.Tensor]:
        """text [B, T_text] -> spect [B, max_mel_len, n_mel] and num_frames [B]
        (roar_tpu/models/fastpitch.py:403-456)."""
        spk_emb = self.get_speaker_embedding(speaker)
        prosody_cond = spk_emb if self.condition_prosody else None
        decoder_cond = spk_emb if self.condition_decoder else None

        enc_out, enc_mask = self.encoder_module(text, conditioning=spk_emb)
        log_durs_predicted = self.duration_predictor_module(enc_out, enc_mask, prosody_cond)
        durs_predicted = log_to_duration(log_durs_predicted, self.min_token_duration,
                                         self.max_token_duration, enc_mask[..., 0])
        pitch_predicted = self.pitch_predictor_module(enc_out, enc_mask, prosody_cond)
        if pitch is not None:
            pitch_predicted = pitch_predicted + pitch
        enc_out = enc_out + conv1d_btc(self.pitch_emb, pitch_predicted[..., None])

        if self.energy_predictor_module is not None:
            if energy is None:
                energy = self.energy_predictor_module(enc_out, enc_mask, prosody_cond)
            enc_out = enc_out + conv1d_btc(self.energy_emb, energy[..., None])

        len_regulated, dec_lens = regulate_len(durs_predicted, enc_out, pace,
                                               max_len=max_mel_len)
        dec_mask = mask_from_lens(dec_lens, max_mel_len)[..., None].to(len_regulated.dtype)
        dec_out, _ = self.decoder_module(len_regulated, dec_mask, decoder_cond)
        return {
            "spect": self.proj(dec_out),
            "num_frames": dec_lens,
            "durs_predicted": durs_predicted,
            "log_durs_predicted": log_durs_predicted,
            "pitch_predicted": pitch_predicted,
        }
