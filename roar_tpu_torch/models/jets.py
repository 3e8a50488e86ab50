"""JETS: joint end-to-end text->wav (the FastPitch graph + a HiFi-GAN generator).

Port of roar_tpu/models/jets.py `JETSModule`.  The variance adaptor is
FastPitch's (models/fastpitch.py) with two differences that are kept here:
the aligner's keys are the ENCODER OUTPUT, not the token embeddings, and
there is no mel projection: the decoder output is cut into `segment_size`
frames at random starts (`ops.lengths.rand_slice_segments`) and vocoded by a
trainable `Generator(weight_norm=True)`.  `infer` regulates by the predicted
durations into a caller-chosen decoder bucket and vocodes the whole decoder
output.

Sub-module names are the flax scopes (`encoder_module`, ...,
`speaker_table`, `pitch_emb`, `energy_emb`, `generator`), so
training/convert.py fills the port from the JAX tree by name.  Dropout acts
in training mode only and draws its masks, like the segment starts, from the
generator set with `set_dropout_generator`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from roar_tpu_torch.models.aligner import AlignmentEncoder
from roar_tpu_torch.models.fastpitch import (
    AlignerConfig,
    FFTConfig,
    PredictorConfig,
    _fft_kwargs,
    _predictor,
)
from roar_tpu_torch.models.hifigan import Generator
from roar_tpu_torch.models.submodules import Conv1d, Embedding, set_dropout_generator
from roar_tpu_torch.models.transformer import (
    FFTransformerDecoder,
    FFTransformerEncoder,
    conv1d_btc,
)
from roar_tpu_torch.ops.lengths import (
    average_features,
    log_to_duration,
    mask_from_lens,
    rand_slice_segments,
    regulate_len,
)
from roar_tpu_torch.ops.mas import binarize_attention


class JETSModule(nn.Module):
    """The full JETS generator graph: text -> (wav segments, alignment and
    prosody outputs)."""

    def __init__(self, n_symbols: int, generator: Generator, padding_idx: int = 0,
                 encoder: FFTConfig = FFTConfig(), decoder: FFTConfig = FFTConfig(),
                 duration_predictor: PredictorConfig = PredictorConfig(),
                 pitch_predictor: PredictorConfig = PredictorConfig(),
                 energy_predictor: Optional[PredictorConfig] = None,
                 aligner: Optional[AlignerConfig] = AlignerConfig(),
                 n_speakers: int = 1, symbols_embedding_dim: int = 384,
                 pitch_embedding_kernel_size: int = 3, energy_embedding_kernel_size: int = 3,
                 segment_size: int = 64, n_mel_channels: int = 80,
                 min_token_duration: int = 0, max_token_duration: int = 75,
                 use_log_energy: bool = True, speaker_emb_condition_prosody: bool = False,
                 speaker_emb_condition_decoder: bool = False,
                 speaker_emb_condition_aligner: bool = False):
        super().__init__()
        d = symbols_embedding_dim
        self.n_speakers = n_speakers
        self.segment_size = segment_size
        self.min_token_duration = min_token_duration
        self.max_token_duration = max_token_duration
        self.use_log_energy = use_log_energy
        self.condition_prosody = speaker_emb_condition_prosody
        self.condition_decoder = speaker_emb_condition_decoder
        self.condition_aligner = speaker_emb_condition_aligner
        self.segment_generator: Optional[torch.Generator] = None
        e, o = encoder, decoder
        self.encoder_module = FFTransformerEncoder(
            e.n_layer, e.n_head, e.d_model, e.d_head, e.d_inner, e.kernel_size,
            n_embed=n_symbols, d_embed=d, padding_idx=padding_idx, **_fft_kwargs(e))
        self.decoder_module = FFTransformerDecoder(
            o.n_layer, o.n_head, o.d_model, o.d_head, o.d_inner, o.kernel_size,
            **_fft_kwargs(o))
        self.duration_predictor_module = _predictor(duration_predictor)
        self.pitch_predictor_module = _predictor(pitch_predictor)
        self.energy_predictor_module = _predictor(energy_predictor) if energy_predictor else None
        self.aligner_module = AlignmentEncoder(
            n_mel_channels=n_mel_channels, n_text_channels=aligner.n_text_channels,
            n_att_channels=aligner.n_att_channels, temperature=aligner.temperature,
            condition_types=aligner.condition_types,
            dist_type=aligner.dist_type) if aligner is not None else None
        if n_speakers > 1:
            self.speaker_table = Embedding(n_speakers, d)
        self.pitch_emb = Conv1d(1, d, pitch_embedding_kernel_size, padding="same")
        if energy_predictor is not None:
            self.energy_emb = Conv1d(1, d, energy_embedding_kernel_size, padding="same")
        self.generator = generator

    @property
    def learn_alignment(self) -> bool:
        return self.aligner_module is not None

    def set_dropout_generator(self, generator: Optional[torch.Generator]) -> None:
        """Draw every dropout mask and the segment starts from `generator`
        (on the module's device); None returns them to torch's default."""
        self.segment_generator = generator
        set_dropout_generator(self, generator)

    def get_speaker_embedding(self, speaker):
        if self.n_speakers > 1 and speaker is not None:
            return self.speaker_table(speaker)[:, None, :]  # [B, 1, D]
        return None

    def _variance_adaptor(self, text, pitch, energy, speaker, spec, attn_prior, mel_lens,
                          input_lens) -> Dict[str, Optional[torch.Tensor]]:
        spk_emb = self.get_speaker_embedding(speaker)
        prosody_cond = spk_emb if self.condition_prosody else None
        aligner_cond = spk_emb if self.condition_aligner else None

        enc_out, enc_mask = self.encoder_module(text, conditioning=spk_emb)
        log_durs_predicted = self.duration_predictor_module(enc_out, enc_mask, prosody_cond)
        durs_predicted = log_to_duration(log_durs_predicted, self.min_token_duration,
                                         self.max_token_duration, enc_mask[..., 0])

        attn_soft = attn_hard = attn_hard_dur = attn_logprob = None
        if self.learn_alignment and spec is not None:
            # the aligner's keys are the encoder output (roar_tpu/models/jets.py:126-131)
            attn_soft, attn_logprob = self.aligner_module(
                spec, enc_out, key_mask=enc_mask[..., 0] > 0, attn_prior=attn_prior,
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

        return {
            "enc_out": enc_out, "spk_emb": spk_emb, "durs_predicted": durs_predicted,
            "log_durs_predicted": log_durs_predicted, "pitch_predicted": pitch_predicted,
            "pitch": pitch_tok, "energy_pred": energy_pred, "energy_tgt": energy_tgt,
            "attn_soft": attn_soft, "attn_logprob": attn_logprob, "attn_hard": attn_hard,
            "attn_hard_dur": attn_hard_dur,
        }

    def forward(self, text: torch.Tensor, durs: Optional[torch.Tensor] = None,
                pitch: Optional[torch.Tensor] = None, energy: Optional[torch.Tensor] = None,
                speaker: Optional[torch.Tensor] = None, pace: float = 1.0,
                spec: Optional[torch.Tensor] = None, attn_prior: Optional[torch.Tensor] = None,
                mel_lens: Optional[torch.Tensor] = None,
                input_lens: Optional[torch.Tensor] = None,
                max_mel_len: Optional[int] = None) -> Dict[str, Optional[torch.Tensor]]:
        """Training forward (roar_tpu/models/jets.py:187-240): the variance
        adaptor, length regulation by the hard durations, the decoder, one
        random `segment_size`-frame segment per row vocoded to `wav`
        [B, segment_size * hop]; `z_start_idxs` [B] are the segments' first
        frames."""
        va = self._variance_adaptor(text, pitch, energy, speaker, spec, attn_prior, mel_lens,
                                    input_lens)
        decoder_cond = va["spk_emb"] if self.condition_decoder else None
        if max_mel_len is None:
            max_mel_len = spec.shape[1] if spec is not None else None
        if self.learn_alignment and spec is not None:
            dec_durs = va["attn_hard_dur"]
        elif spec is None:
            dec_durs = durs if durs is not None else va["durs_predicted"]
        else:
            raise ValueError("spec provided but alignment is not learned")
        if max_mel_len is None:
            raise ValueError("max_mel_len is required when no spec sets the decoder length")
        len_regulated, dec_lens = regulate_len(dec_durs, va["enc_out"], pace, max_len=max_mel_len)
        dec_mask = mask_from_lens(dec_lens, len_regulated.shape[1])[..., None].to(
            len_regulated.dtype)
        dec_out, _ = self.decoder_module(len_regulated, dec_mask, decoder_cond)

        segments, z_start_idxs = rand_slice_segments(
            dec_out.transpose(1, 2), mel_lens, self.segment_size, self.segment_generator)
        wav = self.generator(segments.transpose(1, 2))

        out = {k: v for k, v in va.items() if k not in ("enc_out", "spk_emb")}
        out.update(wav=wav, num_frames=dec_lens, z_start_idxs=z_start_idxs)
        return out

    def infer(self, text: torch.Tensor, pitch: Optional[torch.Tensor] = None,
              speaker: Optional[torch.Tensor] = None, energy: Optional[torch.Tensor] = None,
              pace: float = 1.0, max_mel_len: int = 2048) -> Dict[str, torch.Tensor]:
        """Whole-utterance synthesis (roar_tpu/models/jets.py:242-289): text
        [B, T_text] -> wav [B, max_mel_len * hop], valid for num_frames [B]
        frames."""
        spk_emb = self.get_speaker_embedding(speaker)
        prosody_cond = spk_emb if self.condition_prosody else None
        decoder_cond = spk_emb if self.condition_decoder else None

        enc_out, enc_mask = self.encoder_module(text, conditioning=spk_emb)
        log_durs_predicted = self.duration_predictor_module(enc_out, enc_mask, prosody_cond)
        durs_predicted = log_to_duration(log_durs_predicted, self.min_token_duration,
                                         self.max_token_duration, enc_mask[..., 0])
        if pitch is None:
            pitch = self.pitch_predictor_module(enc_out, enc_mask, prosody_cond)
        enc_out = enc_out + conv1d_btc(self.pitch_emb, pitch[..., None])
        if self.energy_predictor_module is not None:
            if energy is None:
                energy = self.energy_predictor_module(enc_out, enc_mask, prosody_cond)
            enc_out = enc_out + conv1d_btc(self.energy_emb, energy[..., None])

        len_regulated, dec_lens = regulate_len(durs_predicted, enc_out, pace,
                                               max_len=max_mel_len)
        dec_mask = mask_from_lens(dec_lens, max_mel_len)[..., None].to(len_regulated.dtype)
        dec_out, _ = self.decoder_module(len_regulated, dec_mask, decoder_cond)
        return {"wav": self.generator(dec_out), "num_frames": dec_lens,
                "durs_predicted": durs_predicted, "log_durs_predicted": log_durs_predicted}
