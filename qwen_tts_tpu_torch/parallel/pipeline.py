"""Two-stage pipeline parallelism: the talker decode (stage 0) | the codec
(stage 1), overlapped across streaming segments (the counterpart of
``qwen_tts_tpu/parallel/pipeline.py``).

The natural stage boundary of this model is not the talker's layer stack
but the two phases of TTS itself: the autoregressive talker and sub-talker
loop and the feed-forward codec have different profiles (small-batch
decode against convolutions), so each gets its own device (or stream) and
segments flow between them:

    talker:  seg0 | seg1 | seg2 | ...
    codec:          wav0 | wav1 | wav2 | ...

The JAX module gets the overlap from async dispatch. Here it is explicit:
the codec runs on a CUDA stream of its own, on ``dev_codec``, and takes
each segment's codes from the host once the talker's stream has produced
them; the host enqueues segment t+1's decode before it reads segment t's
audio. Both stages cost the host little: the talker's segments are replays
of the captured frame (``generate.py``), the codec's windows replays of a
graph captured once per window shape with a memory pool of its own
(``graphs.Graph(private_pool=True)``), so that it may replay on its stream
while the frame replays on the talker's. (Run eagerly, the codec's
hundreds of launches would hold the host while the talker's stream
waits.) Codes and waveforms are those of one device: the split moves data,
not arithmetic.

``dev_talker = dev_codec = cuda:0`` runs both stages on one card, on two
streams; on the CPU the stages run one after the other.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from qwen_tts_tpu_torch import graphs
from qwen_tts_tpu_torch.generate import batch_prompts, decode_segment, init_decode
from qwen_tts_tpu_torch.models import codec as codec_mod


def _place(tree, device: torch.device):
    """``tree`` (dicts of tensors) on ``device``: the same tree where it is
    there already, else a copy. A serving pack (``SubtalkerPack``) stays on
    its card: moving one raises."""
    if _on(tree, device):
        return tree
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if type(tree) is not dict:
        raise ValueError("a serving pack cannot move between devices: place the model "
                         "before quantize_for_serving")
    return {k: _place(v, device) for k, v in tree.items()}


def _device(device) -> torch.device:
    """``device`` with its index ("cuda" is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _on(tree, device: torch.device) -> bool:
    if isinstance(tree, dict):
        return all(_on(v, device) for v in tree.values())
    return not isinstance(tree, torch.Tensor) or tree.device == device


class _CodecStage:
    """``codec_decode`` of one window shape captured on ``device`` with a
    memory pool of its own; ``run`` replays it on the current stream."""

    def __init__(self, codec_params: dict, dec_cfg, shape, device: torch.device):
        with torch.cuda.device(device):
            self.window = torch.zeros(shape, dtype=torch.int64, device=device)
            self.graph = graphs.Graph(
                lambda: codec_mod.codec_decode(codec_params, dec_cfg, self.window),
                private_pool=True)

    def run(self, window: np.ndarray) -> torch.Tensor:
        self.window.copy_(torch.from_numpy(window).pin_memory(), non_blocking=True)
        self.graph.replay()
        return self.graph.outputs


class TwoStagePipeline:
    """Talker and sub-talker params on ``dev_talker``, codec params on
    ``dev_codec``; ``stream`` runs segment-streamed generation with the two
    stages overlapped. With no devices given it takes the first two cards
    and raises ``ValueError`` where there are fewer.

    After a stream, ``codes`` holds the codes it emitted ([T, num_quantizers]
    int64) and ``stage_ms`` the device milliseconds of the prefill and of
    each segment of each stage (CUDA events on the stage's stream; empty on
    the CPU)."""

    def __init__(self, model, dev_talker=None, dev_codec=None, segment_frames: int = 25):
        if dev_talker is None or dev_codec is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if n < 2:
                raise ValueError(f"2-stage pipeline needs >= 2 devices, have {n}")
            dev_talker, dev_codec = torch.device("cuda", 0), torch.device("cuda", 1)
        self.model = model
        self.dev_talker, self.dev_codec = _device(dev_talker), _device(dev_codec)
        self.segment_frames = segment_frames
        self.talker_params = _place(model.talker_params, self.dev_talker)
        self.st_params = _place(model.subtalker_params, self.dev_talker)
        self.codec_params = _place(model.codec_params, self.dev_codec)
        self.codec_stream = (torch.cuda.Stream(device=self.dev_codec)
                             if self.dev_codec.type == "cuda" else None)
        self._codec_graphs = {}  # window shape -> _CodecStage
        self.stage_ms = {"prefill": [], "talker": [], "codec": []}
        self.codes = np.zeros((0, model.cfg.codec.decoder.num_quantizers), np.int64)

    def _events(self, stage: str, stream) -> Tuple[Optional[torch.cuda.Event], ...]:
        if stream is None:
            return None, None
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        self._timed.append((stage, start, end))
        return start, end

    def stream(self, prompt, params, *, left_context_frames: int = 25) -> Iterator[np.ndarray]:
        """Yield waveform chunks (f32 numpy): the talker decodes segment t+1
        while the codec synthesizes segment t's audio. Windows and the budget
        rule are the JAX module's: a row that runs out of budget drops its
        final frame (11 requested frames give 10 emitted), and each window of
        ``left_context_frames + segment_frames`` codes is right-padded with
        code 0 (the codec is causal)."""
        m = self.model
        dec_cfg = m.cfg.codec.decoder
        nq = dec_cfg.num_quantizers
        up = m.cfg.codec.decode_upsample_rate
        dtype = self.talker_params["norm"].dtype
        seg = self.segment_frames
        talker_stream = (torch.cuda.current_stream(self.dev_talker)
                         if self.dev_talker.type == "cuda" else None)
        self._timed: List[tuple] = []

        embeds, mask, trailing, _ = batch_prompts([prompt], bucket=16)
        embeds, mask = embeds.to(self.dev_talker, dtype), mask.to(self.dev_talker)
        trailing = trailing.to(self.dev_talker, dtype)
        generator = torch.Generator(device=self.dev_talker).manual_seed(params.seed)
        start, end = self._events("prefill", talker_stream)
        if start is not None:
            start.record(talker_stream)
        state = init_decode(
            self.talker_params, m.cfg.talker, embeds, mask,
            sampling=params.talker_sampling(),
            max_cache_len=embeds.shape[1] + params.max_new_tokens, generator=generator,
            kv_int8=m.kv_int8)
        if end is not None:
            end.record(talker_stream)
        window_len = left_context_frames + seg

        history = np.zeros((0, nq), np.int64)
        emitted = 0
        prev_gen = 0
        pending = None  # (waveform on dev_codec, its done event, ctx, n)

        def flush(p):
            wav_dev, done, ctx, n = p
            if done is not None:
                done.synchronize()
            return wav_dev[0, ctx * up: (ctx + n) * up].cpu().numpy()

        while True:
            start, end = self._events("talker", talker_stream)
            if start is not None:
                start.record(talker_stream)
            state, seg_codes = decode_segment(
                self.talker_params, self.st_params, m.cfg.talker, state, trailing,
                sampling=params.talker_sampling(), st_sampling=params.subtalker_sampling(),
                segment=seg, step_limit=params.max_new_tokens)
            if end is not None:
                end.record(talker_stream)
            # Segment t's codes on the host (waits for the talker's stream
            # only): the codec of segment t - 1 runs on beside it.
            new_gen = int(state.num_gen[0])
            seg_h = seg_codes.cpu().numpy()
            fresh = new_gen - prev_gen
            hit_budget = new_gen >= params.max_new_tokens
            stopped = bool(state.eos.all()) if (hit_budget or fresh <= 0) else False
            done = fresh <= 0 or stopped or hit_budget
            emit = fresh
            if done and hit_budget and not stopped:
                emit -= 1  # budget rows drop the unexpanded final frame
            if emit > 0:
                history = np.concatenate([history, seg_h[0, :fresh, :nq]], axis=0)
                ctx = min(left_context_frames, emitted)
                window = np.zeros((1, window_len, nq), np.int64)
                window[0, : ctx + emit] = history[emitted - ctx: emitted + emit]
                if pending is not None:
                    yield flush(pending)
                pending = (*self._codec(window, dec_cfg), ctx, emit)
                emitted += emit
                prev_gen = new_gen
            if done:
                break
        if pending is not None:
            yield flush(pending)
        self.codes = history[:emitted]
        self.stage_ms = {"prefill": [], "talker": [], "codec": []}
        for stage, start, end in self._timed:
            end.synchronize()
            self.stage_ms[stage].append(start.elapsed_time(end))

    def _codec(self, window: np.ndarray, dec_cfg):
        """Enqueue one window's codec decode on the codec stage; returns
        (waveform, the event that marks it done or None on the CPU). On the
        card the waveform is the window graph's output buffer, which the
        next window's replay rewrites: ``stream`` reads it first."""
        if self.codec_stream is None:
            codes = torch.as_tensor(window, device=self.dev_codec)
            return codec_mod.codec_decode(self.codec_params, dec_cfg, codes), None
        graph = self._codec_graphs.get(window.shape)
        if graph is None:
            graph = _CodecStage(self.codec_params, dec_cfg, window.shape, self.dev_codec)
            self._codec_graphs[window.shape] = graph
        start, end = self._events("codec", self.codec_stream)
        with torch.cuda.stream(self.codec_stream):
            start.record(self.codec_stream)
            wav = graph.run(window)
            end.record(self.codec_stream)
        return wav, end

    def synthesize(self, prompt, params) -> np.ndarray:
        return np.concatenate(list(self.stream(prompt, params)) or
                              [np.zeros((0,), np.float32)])
