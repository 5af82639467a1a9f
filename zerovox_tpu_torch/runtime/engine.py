"""Serving engine: mel-length buckets, batch ladder, batched synthesis on one device.

The engine runs the encoder + length regulator + StyleTTS decoder at the
full max_seq_len (the decoder's InstanceNorms reduce over the whole padded
time axis, so they must see the same padded buffer as the reference), reads
the predicted mel lengths, and runs only the heavy vocoder at the smallest
bucket that covers mel_len plus the vocoder's receptive field, so the
trimmed audio equals the full-length run's.

Batches are padded (first row repeated) to the smallest size of the batch
ladder and split at its top, as in the JAX package: the set of shapes a
serving process ever runs stays len(mel_buckets) x len(batch_ladder), and
the ladder top bounds the memory of one dispatch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ZeroVoxConfig
from ..device import resolve_device
from ..models import fs2_encoder, hifigan, styletts_decoder
from ..ops import durations_from_log, length_regulate
from ..params import params_to_device


class TTSEngine:
    """High-level synthesis engine over a loaded model on one device."""

    def __init__(self, params, cfg: ZeroVoxConfig,
                 mel_buckets: Sequence[int] = (256, 512, 1024),
                 precision: str = "float32",
                 batch_ladder: Sequence[int] = (1, 2, 4, 8),
                 device="cuda"):
        if precision == "bfloat16":
            raise NotImplementedError(
                "precision='bfloat16' is the bf16 serving path (the kernel's "
                "bf16 dots), a later slice of the port; use 'float32'")
        if precision != "float32":
            raise ValueError(f"unknown precision {precision!r}")
        if cfg.compute_dtype != "float32":
            raise NotImplementedError("the port runs compute_dtype='float32' only")
        self.device = resolve_device(device)
        self.params = params_to_device(params, self.device)
        self.cfg = cfg
        # the MRF kernel's weight layout, made once (the CPU path does not read it)
        self.vocoder_packed = (hifigan.pack_vocoder(self.params, cfg)
                               if self.device.type == "cuda" else None)
        # truncating the mel at `bucket` only perturbs vocoder outputs within
        # the receptive field of the cut: mel_len + margin <= bucket keeps
        # the trimmed waveform equal to the full run's
        self.margin = hifigan.receptive_field_frames(cfg)
        bks = sorted(set(int(b) for b in mel_buckets if b < cfg.max_seq_len))
        self.mel_buckets: Tuple[int, ...] = tuple(bks) + (cfg.max_seq_len,)
        if not batch_ladder:
            raise ValueError("batch_ladder must be non-empty")
        self.batch_ladder: Tuple[int, ...] = tuple(sorted(set(
            int(b) for b in batch_ladder)))

    # ------------------------------------------------------------ programs
    @torch.inference_mode()
    def _front(self, src_seq, puncts, style_embed, num_phonemes):
        """Encoder + length regulator + decoder at full max_seq_len."""
        cfg = self.cfg
        mask = (fs2_encoder.phoneme_mask(num_phonemes, src_seq.shape[-1])
                if cfg.use_attention_mask else None)
        features, log_dur = fs2_encoder.encode(
            self.params, cfg, src_seq, puncts, style_embed, phoneme_mask=mask)
        durations = durations_from_log(log_dur, cfg.max_seq_len)
        hidden, mel_len = length_regulate(
            features, durations, cfg.max_seq_len, num_phonemes=num_phonemes)
        mel = styletts_decoder.decode(self.params, cfg, hidden, style_embed)
        return mel, mel_len

    @torch.inference_mode()
    def _back(self, mel_b: torch.Tensor, pcm16: bool) -> np.ndarray:
        """Vocoder on a bucket-length mel; the PCM16 quantisation (clip,
        scale, truncate toward zero, as io.wav.float_to_pcm16) runs on the
        device so the host fetch moves int16."""
        wav = hifigan.vocode(self.params, self.cfg, mel_b, self.vocoder_packed)
        if pcm16:
            wav = (torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
        return wav.cpu().numpy()

    # ------------------------------------------------------------- geometry
    def pick_bucket(self, mel_len: int) -> int:
        """Smallest bucket covering mel_len + the vocoder receptive field."""
        need = min(int(mel_len) + self.margin, self.cfg.max_seq_len)
        for b in self.mel_buckets:
            if need <= b:
                return b
        return self.mel_buckets[-1]

    def ladder_size(self, n: int) -> int:
        """Smallest ladder batch covering n (capped at the ladder top)."""
        for s in self.batch_ladder:
            if n <= s:
                return s
        return self.batch_ladder[-1]

    def _ladder_chunks(self, idxs: Sequence[int]):
        """Split an index list into ladder-top chunks, each padded (first
        index repeated) up to its ladder size.  Yields (padded_idxs, n_real)."""
        top = self.batch_ladder[-1]
        for c0 in range(0, len(idxs), top):
            chunk = list(idxs[c0:c0 + top])
            size = self.ladder_size(len(chunk))
            yield chunk + [chunk[0]] * (size - len(chunk)), len(chunk)

    def group_by_bucket(self, predicted_lens: Sequence[int]) -> Dict[int, List[int]]:
        """Group utterance indices by their mel bucket (for batch packing)."""
        groups: Dict[int, List[int]] = {}
        for i, L in enumerate(predicted_lens):
            groups.setdefault(self.pick_bucket(int(L)), []).append(i)
        return groups

    def warmup(self, batch: int = 1, pcm16: bool = False):
        """Run every shape serving can hit for batches up to `batch` once:
        the front and the vocoder at each bucket, at every ladder size
        <= ladder_size(batch).  On a card this builds the MRF kernel and
        lets cuDNN pick its algorithms before the first request."""
        cfg = self.cfg
        for s in (s for s in self.batch_ladder if s <= self.ladder_size(batch)):
            src = torch.zeros((s, cfg.max_n_phonemes), dtype=torch.long,
                              device=self.device)
            style = torch.zeros((s, cfg.d_model), device=self.device)
            nph = torch.zeros((s,), dtype=torch.long, device=self.device)
            mel, _ = self._front(src, src, style, nph)
            for b in self.mel_buckets:
                for v in ((False, True) if pcm16 else (False,)):
                    self._back(mel[:, :b], v)

    # ------------------------------------------------------------------ API
    def synthesize(self, src_seq, puncts, style_embed, num_phonemes=None,
                   trim: bool = True, pcm16: bool = False
                   ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Batched synthesis with bucket dispatch: the whole batch vocodes at
        the bucket of its longest utterance (synthesize_packed routes each
        bucket group separately).

        Returns (per-utterance waveforms, trimmed to mel_len*hop when
        trim=True, else the full padded buffer; mel_len array)."""
        mel, mel_len_h = self._run_front(src_seq, puncts, style_embed, num_phonemes)
        # trim=False promises the reference's full padded buffer, so it
        # vocodes at the max bucket
        bucket = (self.pick_bucket(int(mel_len_h.max()))
                  if trim else self.mel_buckets[-1])
        outs = []
        for padded, n in self._ladder_chunks(range(mel.shape[0])):
            idx = torch.as_tensor(padded, device=self.device)
            outs.append(self._back(mel[idx, :bucket], pcm16)[:n])
        return self._trim(np.concatenate(outs, axis=0), mel_len_h, trim), mel_len_h

    def synthesize_packed(self, src_seq, puncts, style_embed,
                          num_phonemes=None, trim: bool = True,
                          pcm16: bool = False
                          ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Bucket-packed batched synthesis: one vocoder dispatch per bucket
        group (ladder-padded), so short utterances in a mixed batch do not
        pay the longest one's compute.  Outputs match synthesize()."""
        mel, mel_len_h = self._run_front(src_seq, puncts, style_embed, num_phonemes)
        B = mel.shape[0]
        hop = self.cfg.hop_size
        wavs: List[Optional[np.ndarray]] = [None] * B
        groups = (self.group_by_bucket(mel_len_h) if trim
                  else {self.mel_buckets[-1]: list(range(B))})
        for bucket, idxs in groups.items():
            for padded, n in self._ladder_chunks(idxs):
                idx = torch.as_tensor(padded, device=self.device)
                wav_h = self._back(mel[idx, :bucket], pcm16)
                for k, i in enumerate(padded[:n]):
                    wavs[i] = wav_h[k, : int(mel_len_h[i]) * hop] if trim else wav_h[k]
        return wavs, mel_len_h

    # -------------------------------------------------------------- helpers
    def _run_front(self, src_seq, puncts, style_embed, num_phonemes):
        """Front at ladder sizes; returns (device mel (B, T, mels), host mel_len)."""
        cfg = self.cfg
        dev = self.device
        src = torch.as_tensor(np.asarray(src_seq), device=dev).long()
        pun = torch.as_tensor(np.asarray(puncts), device=dev).long()
        sty = torch.as_tensor(np.asarray(style_embed, np.float32), device=dev)
        B = src.shape[0]
        if B == 0:
            raise ValueError("empty batch")
        nph = (torch.full((B,), cfg.max_n_phonemes, device=dev)
               if num_phonemes is None
               else torch.as_tensor(np.asarray(num_phonemes), device=dev).long())
        mels, lens = [], []
        for padded, n in self._ladder_chunks(range(B)):
            idx = torch.as_tensor(padded, device=dev)
            mel_c, len_c = self._front(src[idx], pun[idx], sty[idx], nph[idx])
            mels.append(mel_c[:n])
            lens.append(len_c[:n])
        mel = mels[0] if len(mels) == 1 else torch.cat(mels, dim=0)
        return mel, torch.cat(lens).cpu().numpy()

    def _trim(self, wav_h: np.ndarray, mel_len_h: np.ndarray, trim: bool
              ) -> List[np.ndarray]:
        if not trim:
            return [wav_h[i] for i in range(wav_h.shape[0])]
        hop = self.cfg.hop_size
        return [wav_h[i, : int(mel_len_h[i]) * hop] for i in range(wav_h.shape[0])]
