"""FastPitch: parallel text->mel with learned alignment.

Port of roar_tpu/models/fastpitch.py: `ConvReLUNorm`, `TemporalPredictor`,
`FFTConfig`, `PredictorConfig`, `AlignerConfig` and `FastPitchModule` with its
training `forward` (fastpitch.py:270-401: encoder FFT -> duration, pitch and
energy predictors -> aligner + MAS on the device -> pitch/energy embeddings ->
length regulation by the hard durations -> decoder FFT -> mel projection) and
`infer` (fastpitch.py:403-456: the same with predicted durations into a
caller-chosen decoder bucket).  Dropout acts in training mode only.  GST is
not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from roar_tpu_torch.models.aligner import AlignmentEncoder
from roar_tpu_torch.models.submodules import (
    XAVIER_GAINS,
    ConditionalInput,
    ConditionalLayerNorm,
    ConvNorm,
    Dropout,
)
from roar_tpu_torch.models.transformer import (
    FFTransformerDecoder,
    FFTransformerEncoder,
    conv1d_btc,
)
from roar_tpu_torch.ops.lengths import (
    average_features,
    log_to_duration,
    mask_from_lens,
    regulate_len,
)
from roar_tpu_torch.ops.mas import binarize_attention


class ConvReLUNorm(nn.Module):
    """Conv1d -> ReLU -> ConditionalLayerNorm -> Dropout over [B, T, C]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 condition_dim: int = 384, condition_types: Sequence[str] = (),
                 dropout: float = 0.0):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size, padding="same")
        self.norm = ConditionalLayerNorm(out_channels, condition_dim, condition_types)
        self.drop = Dropout(dropout)

    def forward(self, x, conditioning=None):
        return self.drop(self.norm(F.relu(conv1d_btc(self.conv, x)), conditioning))


class TemporalPredictor(nn.Module):
    """Predicts one float per time step."""

    def __init__(self, input_size: int, filter_size: int, kernel_size: int,
                 n_layers: int = 2, condition_types: Sequence[str] = (),
                 dropout: float = 0.0):
        super().__init__()
        self.cond_input = ConditionalInput(input_size, input_size, condition_types)
        self.layers = nn.ModuleList(
            ConvReLUNorm(input_size if i == 0 else filter_size, filter_size, kernel_size,
                         condition_dim=input_size, condition_types=condition_types,
                         dropout=dropout)
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
    dropout: float = 0.1
    dropatt: float = 0.1
    dropemb: float = 0.0
    pre_lnorm: bool = False
    condition_types: Sequence[str] = ()
    use_rope: bool = False
    use_flash: bool = False


@dataclasses.dataclass(frozen=True)
class PredictorConfig:
    input_size: int = 384
    kernel_size: int = 3
    filter_size: int = 256
    dropout: float = 0.1
    n_layers: int = 2
    condition_types: Sequence[str] = ()


@dataclasses.dataclass(frozen=True)
class AlignerConfig:
    n_text_channels: int = 384
    n_att_channels: int = 80
    temperature: float = 0.0005
    condition_types: Sequence[str] = ()
    dist_type: str = "l2"


def _predictor(cfg: PredictorConfig) -> TemporalPredictor:
    return TemporalPredictor(cfg.input_size, cfg.filter_size, cfg.kernel_size,
                             cfg.n_layers, cfg.condition_types, cfg.dropout)


def _fft_kwargs(cfg: FFTConfig) -> Dict[str, object]:
    return dict(pre_lnorm=cfg.pre_lnorm, condition_types=cfg.condition_types,
                use_rope=cfg.use_rope, use_flash=cfg.use_flash, dropout=cfg.dropout,
                dropatt=cfg.dropatt, dropemb=cfg.dropemb)


def _trunc_normal(t: torch.Tensor, std: float, generator) -> None:
    """jax's truncated normal at +-2 sigma, rescaled to the asked std."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = lo + (1.0 - 2.0 * lo) * torch.rand(t.shape, generator=generator)
    t.copy_(torch.erfinv(2.0 * u - 1.0) * (math.sqrt(2.0) * std / 0.87962566103423978))


@torch.no_grad()
def init_parameters(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Draw every parameter under `module` from the distribution the flax
    module's initialisers use: lecun-normal kernels and zero biases for Dense
    and Conv, xavier-uniform with the named gain for `ConvNorm`, fan-in
    normal embeddings, LayerNorm at (1, 0), and conditional-LayerNorm
    projections at the identity (weights 0, scale bias 1)."""
    xavier = {id(m.conv): XAVIER_GAINS[m.w_init_gain] for m in module.modules()
              if isinstance(m, ConvNorm)}
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            fan_in = m.weight[0].numel()
            if id(m) in xavier:
                fan_out = m.weight.shape[0] * (m.weight.shape[2] if m.weight.dim() == 3 else 1)
                bound = xavier[id(m)] * (6.0 / (fan_in + fan_out)) ** 0.5
                m.weight.copy_((torch.rand(m.weight.shape, generator=generator) * 2 - 1) * bound)
            else:
                _trunc_normal(m.weight, fan_in ** -0.5, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * m.weight.shape[1] ** -0.5)
        elif isinstance(m, nn.LayerNorm) and m.elementwise_affine:
            m.weight.fill_(1.0)
            m.bias.zero_()
    for m in module.modules():
        if isinstance(m, ConditionalLayerNorm) and m.condition:
            m.scale_proj.weight.zero_()
            m.scale_proj.bias.fill_(1.0)
            m.shift_proj.weight.zero_()


class FastPitchModule(nn.Module):
    """The full FastPitch graph."""

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
                 speaker_emb_condition_decoder: bool = False,
                 aligner: Optional[AlignerConfig] = None, use_log_energy: bool = True,
                 speaker_emb_condition_aligner: bool = False):
        super().__init__()
        d = symbols_embedding_dim
        self.n_speakers = n_speakers
        self.min_token_duration = min_token_duration
        self.max_token_duration = max_token_duration
        self.use_log_energy = use_log_energy
        self.condition_prosody = speaker_emb_condition_prosody
        self.condition_decoder = speaker_emb_condition_decoder
        self.condition_aligner = speaker_emb_condition_aligner
        e = encoder
        self.encoder_module = FFTransformerEncoder(
            e.n_layer, e.n_head, e.d_model, e.d_head, e.d_inner, e.kernel_size,
            n_embed=n_symbols, d_embed=d, padding_idx=padding_idx, **_fft_kwargs(e))
        o = decoder
        self.decoder_module = FFTransformerDecoder(
            o.n_layer, o.n_head, o.d_model, o.d_head, o.d_inner, o.kernel_size,
            **_fft_kwargs(o))
        self.duration_predictor_module = _predictor(duration_predictor)
        self.pitch_predictor_module = _predictor(pitch_predictor)
        self.energy_predictor_module = _predictor(energy_predictor) if energy_predictor else None
        if n_speakers > 1:
            self.speaker_table = nn.Embedding(n_speakers, d)
        self.pitch_emb = nn.Conv1d(1, d, pitch_embedding_kernel_size, padding="same")
        if energy_predictor is not None:
            self.energy_emb = nn.Conv1d(1, d, energy_embedding_kernel_size, padding="same")
        self.proj = nn.Linear(decoder.d_model, n_mel_channels)
        # registered last: the modules before it keep their order for callers
        # that fill parameters in `modules()` order
        self.aligner_module = AlignmentEncoder(
            n_mel_channels=n_mel_channels, n_text_channels=aligner.n_text_channels,
            n_att_channels=aligner.n_att_channels, temperature=aligner.temperature,
            condition_types=aligner.condition_types,
            dist_type=aligner.dist_type) if aligner is not None else None

    @property
    def learn_alignment(self) -> bool:
        return self.aligner_module is not None

    def get_speaker_embedding(self, speaker):
        if self.n_speakers > 1 and speaker is not None:
            return self.speaker_table(speaker)[:, None, :]  # [B, 1, D]
        return None

    def forward(self, text: torch.Tensor, durs: Optional[torch.Tensor] = None,
                pitch: Optional[torch.Tensor] = None, energy: Optional[torch.Tensor] = None,
                speaker: Optional[torch.Tensor] = None, pace: float = 1.0,
                spec: Optional[torch.Tensor] = None,
                attn_prior: Optional[torch.Tensor] = None,
                mel_lens: Optional[torch.Tensor] = None,
                input_lens: Optional[torch.Tensor] = None,
                max_mel_len: Optional[int] = None) -> Dict[str, Optional[torch.Tensor]]:
        """Training / teacher-forced forward (roar_tpu/models/fastpitch.py:270-401).
        spec: [B, T_mel, n_mel] ground-truth mel when alignment is learned."""
        spk_emb = self.get_speaker_embedding(speaker)
        prosody_cond = spk_emb if self.condition_prosody else None
        decoder_cond = spk_emb if self.condition_decoder else None
        aligner_cond = spk_emb if self.condition_aligner else None

        enc_out, enc_mask = self.encoder_module(text, conditioning=spk_emb)
        log_durs_predicted = self.duration_predictor_module(enc_out, enc_mask, prosody_cond)
        durs_predicted = log_to_duration(log_durs_predicted, self.min_token_duration,
                                         self.max_token_duration, enc_mask[..., 0])

        attn_soft = attn_hard = attn_hard_dur = attn_logprob = None
        if self.learn_alignment and spec is not None:
            text_emb, _ = self.encoder_module.embed(text)
            attn_soft, attn_logprob = self.aligner_module(
                spec, text_emb, key_mask=enc_mask[..., 0] > 0, attn_prior=attn_prior,
                conditioning=aligner_cond)
            attn_hard = binarize_attention(attn_soft, input_lens, mel_lens)
            attn_hard_dur = attn_hard[:, 0].sum(dim=1)  # [B, T_text]

        pitch_predicted = self.pitch_predictor_module(enc_out, enc_mask, prosody_cond)
        if pitch is not None:
            if self.learn_alignment and pitch.shape[-1] != pitch_predicted.shape[-1]:
                pitch_tok = average_features(pitch[:, None, :], attn_hard_dur)[:, 0]
            elif not self.learn_alignment:
                pitch_tok = average_features(pitch[:, None, :], durs_predicted)[:, 0]
            else:
                pitch_tok = pitch
            pitch_emb = conv1d_btc(self.pitch_emb, pitch_tok[..., None].to(enc_out.dtype))
        else:
            pitch_tok = None
            pitch_emb = conv1d_btc(self.pitch_emb, pitch_predicted[..., None])
        enc_out = enc_out + pitch_emb

        energy_pred = energy_tgt = None
        if self.energy_predictor_module is not None:
            energy_pred = self.energy_predictor_module(enc_out, enc_mask, prosody_cond)
            if energy is not None:
                durs_for_energy = attn_hard_dur if self.learn_alignment else durs_predicted
                energy_tgt = average_features(energy[:, None, :], durs_for_energy)
                if self.use_log_energy:
                    energy_tgt = torch.log(1.0 + energy_tgt)
                energy_emb = conv1d_btc(self.energy_emb,
                                        energy_tgt[:, 0, :, None].to(enc_out.dtype))
                energy_tgt = energy_tgt[:, 0]
            else:
                energy_emb = conv1d_btc(self.energy_emb, energy_pred[..., None])
            enc_out = enc_out + energy_emb

        if max_mel_len is None:
            max_mel_len = spec.shape[1] if spec is not None else None
        if self.learn_alignment and spec is not None:
            dec_durs = attn_hard_dur
        elif spec is None:
            dec_durs = durs if durs is not None else durs_predicted
        else:
            raise ValueError("spec provided but alignment is not learned")
        if max_mel_len is None:
            raise ValueError("max_mel_len is required when no spec sets the decoder length")
        len_regulated, dec_lens = regulate_len(dec_durs, enc_out, pace, max_len=max_mel_len)
        dec_mask = mask_from_lens(dec_lens, max_mel_len)[..., None].to(len_regulated.dtype)
        dec_out, _ = self.decoder_module(len_regulated, dec_mask, decoder_cond)
        return {
            "spect": self.proj(dec_out),
            "num_frames": dec_lens,
            "durs_predicted": durs_predicted,
            "log_durs_predicted": log_durs_predicted,
            "pitch_predicted": pitch_predicted,
            "attn_soft": attn_soft,
            "attn_logprob": attn_logprob,
            "attn_hard": attn_hard,
            "attn_hard_dur": attn_hard_dur,
            "pitch": pitch_tok,
            "energy_pred": energy_pred,
            "energy_tgt": energy_tgt,
        }

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
