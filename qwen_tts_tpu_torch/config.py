"""Configuration dataclasses of the PyTorch port.

The port's own copy of ``qwen_tts_tpu/config.py`` (talker, code predictor,
12 Hz codec with its Mimi encoder, speaker encoder, the 25 Hz tokenizer's DiT
and BigVGAN, and top-level TTS configs, Base checkpoints'
``speaker_encoder_config`` included; the 25 Hz encoder's ``WhisperVQConfig``
lives in ``models/whisper_vq.py``, as in the JAX package). Plain frozen dataclasses that
mirror the reference configs
(qwen_tts/core/models/configuration_qwen3_tts.py and
qwen_tts/core/tokenizer_12hz/configuration_qwen3_tts_tokenizer_v2.py).

Loading from a checkpoint directory parses the same ``config.json`` /
``speech_tokenizer/config.json`` layout the reference consumes
(reference: c/qwen_tts.c:235-355).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Placement:
    """A rank's place in a (dp, tp) mesh (``parallel/mesh.py``), carried by
    the rank's copy of a talker or code-predictor config: the trunk reaches
    its tensor-parallel group through it (``TrunkDims.group``), and the
    sampler its rows of the global batch. A config that carries one counts
    the rank's heads and intermediate width, not the model's.

    ``tp_group`` is None where the part's weights are whole on every rank
    (int8 or fused trunks): it then runs with no collective. ``kv_slice``
    (first, end) names the KV heads the rank caches when the KV heads do not
    divide over tp: ``wk`` / ``wv`` are whole on every rank and the rank
    keeps the heads its q heads map to. ``dp_group`` joins the ranks that
    hold the same shards and different rows."""

    tp_group: Any = None
    tp_rank: int = 0
    tp_size: int = 1
    dp_group: Any = None
    dp_rank: int = 0
    dp_size: int = 1
    kv_slice: Optional[Tuple[int, int]] = None


def placement_of(cfg) -> Optional[Placement]:
    """``cfg``'s placement; None on one device (and for a config without
    the field)."""
    return getattr(cfg, "placement", None)


def _freeze_map(m: Optional[Mapping[str, int]]) -> Tuple[Tuple[str, int], ...]:
    if not m:
        return ()
    return tuple(sorted((str(k).lower(), int(v)) for k, v in m.items()))


@dataclasses.dataclass(frozen=True)
class CodePredictorConfig:
    """Sub-talker ("code predictor") transformer.

    Reference defaults: configuration_qwen3_tts.py:187-211.
    """

    vocab_size: int = 2048
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_hidden_layers: int = 5
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    num_code_groups: int = 32
    # The rank's place in a mesh (``Placement``); None on one device.
    placement: Optional[Placement] = None

    @classmethod
    def from_dict(cls, d: Mapping) -> "CodePredictorConfig":
        keys = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in keys})


@dataclasses.dataclass(frozen=True)
class TalkerConfig:
    """Talker (main autoregressive LM) transformer.

    Reference defaults: configuration_qwen3_tts.py:370-403.
    """

    vocab_size: int = 3072
    hidden_size: int = 1024
    intermediate_size: int = 2048
    num_hidden_layers: int = 20
    num_attention_heads: int = 16
    num_key_value_heads: int = 2
    head_dim: int = 64  # hidden // heads unless overridden
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    # Sections sum to head_dim // 2 (the rotary half-dim); all three position
    # streams are identical for text-only TTS so the merge is an identity
    # (modeling_qwen3_tts.py:713-720 — implemented fully anyway).
    mrope_section: Tuple[int, int, int] = (16, 8, 8)
    mrope_interleaved: bool = False
    num_code_groups: int = 32
    text_hidden_size: int = 2048
    text_vocab_size: int = 151936
    # Talker sliding-window attention option — defaulted OFF exactly like the
    # reference (configuration_qwen3_tts.py:205-224: sliding_window is None
    # unless use_sliding_window; layers i >= max_window_layers are
    # "sliding_attention", the rest full — :248-255). Unused by shipped
    # checkpoints; a config-surface parity knob.
    use_sliding_window: bool = False
    sliding_window: Optional[int] = 4096
    max_window_layers: int = 28
    # Codec-domain special token ids (configuration_qwen3_tts.py:393-399).
    codec_eos_token_id: int = 4198
    codec_think_id: int = 4202
    codec_nothink_id: int = 4203
    codec_think_bos_id: int = 4204
    codec_think_eos_id: int = 4205
    codec_pad_id: int = 4196
    codec_bos_id: int = 4197
    # Speaker / language maps (configuration_qwen3_tts.py:400-402,450-451).
    # The generation-time token ban covers the last `suppress_tail` vocab ids
    # except EOS (modeling_qwen3_tts.py:2059-2063) — 1024 in the reference,
    # leaving exactly [0, codebook_size) as emittable audio tokens.
    suppress_tail: int = 1024
    spk_id: Tuple[Tuple[str, int], ...] = ()
    spk_is_dialect: Tuple[Tuple[str, str], ...] = ()
    codec_language_id: Tuple[Tuple[str, int], ...] = ()
    code_predictor: CodePredictorConfig = dataclasses.field(
        default_factory=CodePredictorConfig
    )
    # The rank's place in a mesh (``Placement``); None on one device.
    placement: Optional[Placement] = None

    @property
    def q_dim(self) -> int:
        return self.num_attention_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_key_value_heads * self.head_dim

    def layer_windows(self):
        """Per-layer attention window for the trunk, or None when every layer
        is full attention. Mirrors the reference layer_types derivation
        (configuration_qwen3_tts.py:248-255): with use_sliding_window, layers
        i >= max_window_layers attend within ``sliding_window``; the rest are
        full attention (encoded as a huge sentinel window so one traced mask
        expression serves both layer kinds). A tuple of ints, one per layer."""
        if (not self.use_sliding_window or self.sliding_window is None
                or self.max_window_layers >= self.num_hidden_layers):
            return None
        return tuple(
            self.sliding_window if i >= self.max_window_layers else 2 ** 30
            for i in range(self.num_hidden_layers)
        )

    def speaker_codec_id(self, speaker: str) -> Optional[int]:
        for name, sid in self.spk_id:
            if name == speaker.lower():
                return sid
        return None

    def language_codec_id(self, language: str) -> Optional[int]:
        for name, lid in self.codec_language_id:
            if name == language.lower():
                return lid
        return None

    def speaker_dialect(self, speaker: str) -> Optional[str]:
        for name, dialect in self.spk_is_dialect:
            if name == speaker.lower() and dialect:
                return dialect
        return None

    @classmethod
    def from_dict(cls, d: Mapping) -> "TalkerConfig":
        d = dict(d)
        cp = d.pop("code_predictor_config", None) or {}
        rope_scaling = d.pop("rope_scaling", None) or {}
        head_dim_guess = d.get("head_dim") or (
            d.get("hidden_size", 1024) // d.get("num_attention_heads", 16)
        )
        half = head_dim_guess // 2
        default_section = (half - 2 * (half // 4), half // 4, half // 4)
        mrope_section = tuple(rope_scaling.get("mrope_section", default_section))
        mrope_interleaved = bool(rope_scaling.get("interleaved", False))
        head_dim = d.get("head_dim")
        if head_dim is None:
            head_dim = d.get("hidden_size", 1024) // d.get("num_attention_heads", 16)
        spk_is_dialect = tuple(
            sorted(
                (str(k).lower(), str(v) if v else "")
                for k, v in (d.pop("spk_is_dialect", None) or {}).items()
            )
        )
        keys = {f.name for f in dataclasses.fields(cls)}
        explicit = {"spk_id", "codec_language_id", "code_predictor", "head_dim",
                    "mrope_section", "mrope_interleaved", "spk_is_dialect"}
        kw = {k: v for k, v in d.items() if k in keys and k not in explicit}
        return cls(
            head_dim=head_dim,
            mrope_section=mrope_section,
            mrope_interleaved=mrope_interleaved,
            spk_id=_freeze_map(d.get("spk_id")),
            spk_is_dialect=spk_is_dialect,
            codec_language_id=_freeze_map(d.get("codec_language_id")),
            code_predictor=CodePredictorConfig.from_dict(cp),
            **kw,
        )


@dataclasses.dataclass(frozen=True)
class CodecDecoderConfig:
    """12 Hz codec decoder ("speech tokenizer V2" decoder).

    Reference defaults: configuration_qwen3_tts_tokenizer_v2.py:72-114.
    """

    codebook_size: int = 2048
    codebook_dim: int = 512
    hidden_size: int = 1024
    latent_dim: int = 1024
    rope_theta: float = 10000.0
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    sliding_window: int = 72
    intermediate_size: int = 3072
    layer_scale_initial_scale: float = 0.01
    rms_norm_eps: float = 1e-5
    num_hidden_layers: int = 8
    num_quantizers: int = 16
    upsample_rates: Tuple[int, ...] = (8, 5, 4, 3)
    upsampling_ratios: Tuple[int, ...] = (2, 2)
    decoder_dim: int = 1536
    vq_epsilon: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def total_upsample(self) -> int:
        total = 1
        for r in self.upsample_rates:
            total *= r
        for r in self.upsampling_ratios:
            total *= r
        return total

    @classmethod
    def from_dict(cls, d: Mapping) -> "CodecDecoderConfig":
        d = dict(d)
        for k in ("upsample_rates", "upsampling_ratios"):
            if k in d:
                d[k] = tuple(d[k])
        keys = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in keys})


@dataclasses.dataclass(frozen=True)
class MimiEncoderConfig:
    """The Mimi fields the 12 Hz encode path reads (``encoder_config`` of
    ``speech_tokenizer/config.json``); defaults are the published Mimi's."""

    num_filters: int = 64
    audio_channels: int = 1
    kernel_size: int = 7
    residual_kernel_size: int = 3
    last_kernel_size: int = 3
    dilation_growth_rate: int = 2
    num_residual_layers: int = 1
    upsampling_ratios: Tuple[int, ...] = (8, 6, 5, 4)
    compress: int = 2
    use_conv_shortcut: bool = False
    hidden_size: int = 512
    num_hidden_layers: int = 8
    num_attention_heads: int = 8
    num_key_value_heads: int = 8
    head_dim: int = 64
    intermediate_size: int = 2048
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    sliding_window: int = 250
    codebook_size: int = 2048
    codebook_dim: int = 256
    vector_quantization_hidden_dimension: int = 256
    num_quantizers: int = 32
    num_semantic_quantizers: int = 1
    frame_rate: float = 12.5
    encodec_frame_rate: float = 25.0
    sampling_rate: int = 24000

    @classmethod
    def from_dict(cls, d: Mapping) -> "MimiEncoderConfig":
        d = dict(d)
        if "upsampling_ratios" in d:
            d["upsampling_ratios"] = tuple(d["upsampling_ratios"])
        keys = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in keys})

    @property
    def encodec_downsample(self) -> int:
        total = 1
        for r in self.upsampling_ratios:
            total *= r
        return total


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Top-level 12 Hz tokenizer config: the decoder, and what the encode
    path reads (``encoder_config``, ``encoder_valid_num_quantizers``,
    ``encode_downsample_rate``).

    Reference: configuration_qwen3_tts_tokenizer_v2.py:143-169.
    """

    decoder: CodecDecoderConfig = dataclasses.field(default_factory=CodecDecoderConfig)
    encoder: MimiEncoderConfig = dataclasses.field(default_factory=MimiEncoderConfig)
    encoder_valid_num_quantizers: int = 16
    input_sample_rate: int = 24000
    output_sample_rate: int = 24000
    decode_upsample_rate: int = 1920
    encode_downsample_rate: int = 1920

    @classmethod
    def from_dict(cls, d: Mapping) -> "CodecConfig":
        d = dict(d)
        dec = d.pop("decoder_config", None) or {}
        enc = d.pop("encoder_config", None) or {}
        keys = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in keys and k not in ("decoder", "encoder")}
        return cls(decoder=CodecDecoderConfig.from_dict(dec),
                   encoder=MimiEncoderConfig.from_dict(enc), **kw)


@dataclasses.dataclass(frozen=True)
class SpeakerEncoderConfig:
    """ECAPA-TDNN speaker encoder (Base models only).

    Reference: configuration_qwen3_tts.py:47-67.
    """

    mel_dim: int = 128
    enc_dim: int = 1024
    enc_channels: Tuple[int, ...] = (512, 512, 512, 512, 1536)
    enc_kernel_sizes: Tuple[int, ...] = (5, 3, 3, 3, 1)
    enc_dilations: Tuple[int, ...] = (1, 2, 3, 4, 1)
    enc_attention_channels: int = 128
    enc_res2net_scale: int = 8
    enc_se_channels: int = 128
    sample_rate: int = 24000

    @classmethod
    def from_dict(cls, d: Mapping) -> "SpeakerEncoderConfig":
        d = dict(d)
        for k in ("enc_channels", "enc_kernel_sizes", "enc_dilations"):
            if k in d:
                d[k] = tuple(d[k])
        keys = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in keys})


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """25 Hz flow-matching DiT (V1 decoder stage 1).

    Reference: configuration_qwen3_tts_tokenizer_v1.py (DiT defaults)."""

    hidden_size: int = 1024
    num_hidden_layers: int = 22
    num_attention_heads: int = 16
    ff_mult: int = 2
    emb_dim: int = 512
    head_dim: int = 64
    rope_theta: float = 10000.0
    block_size: int = 24
    look_ahead_layers: Tuple[int, ...] = (10,)
    look_backward_layers: Tuple[int, ...] = (0, 20)
    repeats: int = 2
    num_embeds: int = 8193
    mel_dim: int = 80
    enc_emb_dim: int = 192
    enc_dim: int = 128
    enc_channels: Tuple[int, ...] = (256, 256, 256, 256, 768)
    enc_kernel_sizes: Tuple[int, ...] = (5, 3, 3, 3, 1)
    enc_dilations: Tuple[int, ...] = (1, 2, 3, 4, 1)
    enc_attention_channels: int = 64
    enc_res2net_scale: int = 2
    enc_se_channels: int = 64

    def spk_encoder_config(self) -> SpeakerEncoderConfig:
        """The ECAPA-TDNN that summarises the reference mel."""
        return SpeakerEncoderConfig(
            mel_dim=self.mel_dim,
            enc_dim=self.enc_dim,
            enc_channels=self.enc_channels,
            enc_kernel_sizes=self.enc_kernel_sizes,
            enc_dilations=self.enc_dilations,
            enc_attention_channels=self.enc_attention_channels,
            enc_res2net_scale=self.enc_res2net_scale,
            enc_se_channels=self.enc_se_channels,
        )

    @classmethod
    def from_dict(cls, d: Mapping) -> "DiTConfig":
        d = dict(d)
        for k in ("look_ahead_layers", "look_backward_layers", "enc_channels",
                  "enc_kernel_sizes", "enc_dilations"):
            if k in d:
                d[k] = tuple(d[k])
        keys = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in keys})


@dataclasses.dataclass(frozen=True)
class BigVGANConfig:
    """25 Hz BigVGAN mel vocoder (V1 decoder stage 2)."""

    mel_dim: int = 80
    upsample_initial_channel: int = 1536
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5)
    )
    upsample_rates: Tuple[int, ...] = (5, 3, 2, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (11, 7, 4, 4, 4, 4)

    @property
    def total_upsample(self) -> int:
        """Waveform samples a mel frame makes."""
        total = 1
        for r in self.upsample_rates:
            total *= r
        return total

    @classmethod
    def from_dict(cls, d: Mapping) -> "BigVGANConfig":
        d = dict(d)
        for k in ("resblock_kernel_sizes", "upsample_rates", "upsample_kernel_sizes"):
            if k in d:
                d[k] = tuple(d[k])
        if "resblock_dilation_sizes" in d:
            d["resblock_dilation_sizes"] = tuple(tuple(x) for x in d["resblock_dilation_sizes"])
        keys = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in keys})


@dataclasses.dataclass(frozen=True)
class CodecV1Config:
    """Top-level 25 Hz tokenizer config (decode side).

    Reference: configuration_qwen3_tts_tokenizer_v1.py top config."""

    dit: DiTConfig = dataclasses.field(default_factory=DiTConfig)
    bigvgan: BigVGANConfig = dataclasses.field(default_factory=BigVGANConfig)
    input_sample_rate: int = 16000
    output_sample_rate: int = 24000
    decode_upsample_rate: int = 960
    encode_downsample_rate: int = 640

    @property
    def samples_per_code(self) -> int:
        """Waveform samples a code really makes: ``repeats`` mel frames of
        ``total_upsample`` samples each (480 at the defaults, where
        ``decode_upsample_rate`` says 960)."""
        return self.dit.repeats * self.bigvgan.total_upsample

    @classmethod
    def from_dict(cls, d: Mapping) -> "CodecV1Config":
        d = dict(d)
        dec = d.pop("decoder_config", None) or {}
        keys = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in keys and k not in ("dit", "bigvgan")}
        return cls(
            dit=DiTConfig.from_dict(dec.get("dit_config") or {}),
            bigvgan=BigVGANConfig.from_dict(dec.get("bigvgan_config") or {}),
            **kw,
        )


@dataclasses.dataclass(frozen=True)
class TTSConfig:
    """Top-level config (reference: configuration_qwen3_tts.py:465-499)."""

    talker: TalkerConfig = dataclasses.field(default_factory=TalkerConfig)
    codec: CodecConfig = dataclasses.field(default_factory=CodecConfig)
    speaker_encoder: SpeakerEncoderConfig = dataclasses.field(
        default_factory=SpeakerEncoderConfig
    )
    tokenizer_type: Optional[str] = None
    tts_model_size: Optional[str] = None
    tts_model_type: Optional[str] = None
    im_start_token_id: int = 151644
    im_end_token_id: int = 151645
    tts_pad_token_id: int = 151671
    tts_bos_token_id: int = 151672
    tts_eos_token_id: int = 151673

    @classmethod
    def from_dict(cls, d: Mapping, codec: Optional[Mapping] = None) -> "TTSConfig":
        d = dict(d)
        talker = TalkerConfig.from_dict(d.pop("talker_config", None) or {})
        spk = SpeakerEncoderConfig.from_dict(d.pop("speaker_encoder_config", None) or {})
        codec_cfg = CodecConfig.from_dict(codec or {})
        keys = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items()
              if k in keys and k not in ("talker", "codec", "speaker_encoder")}
        return cls(talker=talker, codec=codec_cfg, speaker_encoder=spk, **kw)

    @classmethod
    def from_pretrained(cls, model_dir: str) -> "TTSConfig":
        """Parse ``config.json`` (+ ``speech_tokenizer/config.json`` when present)
        from a checkpoint directory, same layout as the reference loader
        (c/qwen_tts.c:235-355)."""
        with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
            top = json.load(f)
        codec = None
        st_path = os.path.join(model_dir, "speech_tokenizer", "config.json")
        if os.path.exists(st_path):
            with open(st_path, encoding="utf-8") as f:
                codec = json.load(f)
        return cls.from_dict(top, codec=codec)


# Tiny config used by the test-suite: same topology, scaled-down dims so CPU
# tests run in seconds without a checkpoint.
def tiny_tts_config() -> TTSConfig:
    talker = TalkerConfig(
        vocab_size=256,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        head_dim=16,
        mrope_section=(4, 2, 2),
        num_code_groups=8,
        text_hidden_size=96,
        text_vocab_size=512,
        codec_eos_token_id=250,
        codec_think_id=244,
        codec_nothink_id=245,
        codec_think_bos_id=246,
        codec_think_eos_id=247,
        codec_pad_id=248,
        codec_bos_id=249,
        spk_id=(("aiden", 100), ("serena", 101)),
        spk_is_dialect=(("aiden", ""), ("serena", "")),
        codec_language_id=(("chinese", 200), ("english", 201)),
        suppress_tail=16,
        code_predictor=CodePredictorConfig(
            vocab_size=128,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            head_dim=16,
            num_code_groups=8,
        ),
    )
    codec = CodecConfig(
        decoder=CodecDecoderConfig(
            codebook_size=256,
            codebook_dim=32,
            hidden_size=64,
            latent_dim=32,
            num_attention_heads=4,
            num_key_value_heads=4,
            sliding_window=8,
            intermediate_size=96,
            num_hidden_layers=2,
            num_quantizers=4,
            upsample_rates=(4, 3),
            upsampling_ratios=(2, 2),
            decoder_dim=64,
        ),
        decode_upsample_rate=48,
        encode_downsample_rate=48,
    )
    speaker = SpeakerEncoderConfig(
        mel_dim=16,
        enc_dim=64,  # == talker hidden: the x-vector fills a codec slot
        enc_channels=(32, 32, 32, 32, 96),
        enc_kernel_sizes=(5, 3, 3, 3, 1),
        enc_dilations=(1, 2, 3, 4, 1),
        enc_attention_channels=16,
        enc_res2net_scale=4,
        enc_se_channels=16,
    )
    # Text-domain special ids must live inside the tiny 512-row text
    # embedding (the flagship defaults 151644+/151671+ are out of range there,
    # and a torch gather raises on them).
    return TTSConfig(talker=talker, codec=codec, speaker_encoder=speaker,
                     tts_model_type="custom_voice",
                     im_start_token_id=501, im_end_token_id=502,
                     tts_pad_token_id=508, tts_bos_token_id=509,
                     tts_eos_token_id=510)
