"""Per-slot continuous batching: requests join and leave live decode slots
(PyTorch counterpart of ``qwen_tts_tpu/continuous.py``).

The decode state is per row (``generate.DecodeState``: per-row frame
counters, cache positions, EOS and frame budgets) and so are the sampling
controls (``ops/sampling_vec.py``), so one captured frame program serves
slots at any depth with any mix of controls. The engine:

* prefills an incoming request at batch 1, at the smallest prefill bucket it
  fits (eager);
* writes its row into a free slot of the pool state in place
  (``_insert_slot``: the pool's tensors are the frame program's buffers, and
  one row of the cache is copied, never the pool's);
* runs fixed-size decode segments over all slots (``decode_segment``: on the
  card replays of the captured frame);
* drains finished slots (EOS, budget, cancel, deadline) to the codec and
  resolves their futures, freeing the slot for the next queued request.

One worker thread does the engine's card work, each admission, segment and
codec decode under ``graphs.device_lock``; a submitting thread holds it only
while it builds its prompt on the card. Submit-time checks (prompt length
against the largest bucket, trailing text against ``trailing_cap``, the
budget against the ceiling) raise in the caller's thread. A request that
fails inside the worker resolves its own future with the exception; the
other slots keep running.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from concurrent.futures import CancelledError, Future
from typing import Dict, List, Optional

import numpy as np
import torch

from qwen_tts_tpu_torch import graphs
from qwen_tts_tpu_torch.generate import (
    STATE_FIELDS,
    DecodeState,
    GenerationParams,
    Prompt,
    batch_prompts,
    build_prompt,
    decode_segment,
    icl_ref_codes,
    init_decode,
)
from qwen_tts_tpu_torch.models.talker import alloc_kv_cache
from qwen_tts_tpu_torch.ops.sampling import SamplingConfig
from qwen_tts_tpu_torch.ops.sampling_vec import VecSampling
from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel, _codec_window


def _insert_slot(
    state: DecodeState,
    trailing: torch.Tensor,    # [B, T_cap, D]
    limits: torch.Tensor,      # [B] int32
    vec: VecSampling,          # per-row talker controls [B]
    st_vec: VecSampling,       # per-row sub-talker controls [B]
    slot: int,
    sub: DecodeState,          # batch-of-1 state fresh from init_decode
    sub_trailing: torch.Tensor,  # [T+1, D], its last row tts_pad
    sub_limit: int,
    sub_vec: VecSampling,      # batch 1 (VecSampling.host_row)
    sub_st_vec: VecSampling,   # batch 1
) -> None:
    """Write the batch-of-1 ``sub`` into row ``slot`` of the pool, in place:
    the caches (and the int8 dicts' ``i8`` / ``s``) on their batch axis 1,
    the per-row fields, the trailing text (padded with its tts_pad row),
    the frame budget and both sampling rows. Copies one row of each;
    the pool's generator stays."""
    for f in STATE_FIELDS:
        dst, src = getattr(state, f), getattr(sub, f)
        if isinstance(dst, dict):  # an int8 cache
            for k in dst:
                dst[k][:, slot].copy_(src[k][:, 0])
        elif f in ("k_cache", "v_cache"):
            dst[:, slot].copy_(src[:, 0])
        else:
            dst[slot].copy_(src[0])
    n = sub_trailing.shape[0]
    trailing[slot, :n].copy_(sub_trailing)
    trailing[slot, n:].copy_(sub_trailing[-1:].expand(trailing.shape[1] - n, -1))
    limits[slot] = sub_limit
    vec.set_rows(slot, sub_vec)
    st_vec.set_rows(slot, sub_st_vec)


def _request_generator(device, seed: int, n: int) -> torch.Generator:
    """The generator of a request's token 0: seeded from (seed, n), the
    counterpart of the JAX package's ``fold_in(PRNGKey(seed), n)``."""
    mixed = np.random.SeedSequence([int(seed) & (2 ** 63 - 1), n]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(mixed[0]) & (2 ** 63 - 1))


@dataclasses.dataclass
class _SlotRequest:
    prompt: Prompt
    params: GenerationParams
    future: "Future[np.ndarray]" = dataclasses.field(default_factory=Future)
    # Per-request streaming: called with (wav_chunk, done) as the slot's
    # frames decode; each slot streams on its own.
    stream_callback: Optional[object] = None
    emitted_frames: int = 0
    # Voice clone (ICL): the reference codes seed the slot's code history as
    # frames already emitted. They are the codec's left context; their audio
    # is never emitted.
    ref_codes: Optional[np.ndarray] = None
    ref_frames: int = 0
    # A cancelled or expired slot is reclaimed at the next segment boundary
    # (its frame budget zeroed, so the frame program stops working on it).
    cancelled: bool = False
    deadline: Optional[float] = None


class ContinuousBatchingEngine:
    """Continuous-batching TTS serving engine over a fixed slot pool, on the
    model's device."""

    def __init__(
        self,
        model: Qwen3TTSModel,
        *,
        num_slots: int = 8,
        segment_frames: int = 25,
        max_new_tokens: int = 512,
        prefill_bucket=64,
        trailing_cap: int = 256,
        stream_context_frames: int = 25,
        sync_dispatch: Optional[bool] = None,
    ):
        self.model = model
        # Double-buffered dispatch (the default) queues segment K+1 before
        # it reads segment K's results, at the cost of one segment of
        # admission and finish lag; sync_dispatch=True (or
        # QTTS_ENGINE_SYNC_DISPATCH=1) reads each segment right after it.
        # On the card a segment's run already waits for the card every
        # CHECK_EVERY frames (generate.py), so what the overlap buys is
        # measured, not assumed (chip_smoke.py's serving phase logs both).
        # The codes are the same either way.
        if sync_dispatch is None:
            sync_dispatch = os.environ.get("QTTS_ENGINE_SYNC_DISPATCH", "") in ("1", "true")
        self.sync_dispatch = bool(sync_dispatch)
        self.num_slots = num_slots
        self.segment_frames = segment_frames
        self.max_new_tokens = max_new_tokens
        # One or several prefill buckets: each admission pads the prompt to
        # the smallest that fits; the pool's cache is sized by the largest.
        buckets = ((prefill_bucket,) if isinstance(prefill_bucket, int)
                   else tuple(prefill_bucket))
        self.prefill_buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.prefill_bucket = self.prefill_buckets[-1]
        self.trailing_cap = trailing_cap
        self.stream_context_frames = stream_context_frames
        self.device = model.device
        self.stats = {"requests": 0, "segments": 0, "frames": 0,
                      # Segment results whose slot was freed (and perhaps
                      # admitted again) before they were read: dropped by
                      # the identity check in _process_segment.
                      "stale_skips": 0,
                      "bucket_admits": {b: 0 for b in self.prefill_buckets},
                      # Host seconds per loop phase: admit = prefill + slot
                      # insertion; segment = dispatch + reading results;
                      # finish = codec decode + resolving futures; emit =
                      # streamed chunks.
                      "time_admit_s": 0.0, "time_segment_s": 0.0,
                      "time_finish_s": 0.0, "time_emit_s": 0.0}
        # Host shadows of each slot's frames and frame budget: the budget
        # changes only at _admit / _abort, and the frames advance only as
        # _process_segment reads them, so neither needs a read of the card.
        self._host_gen = np.zeros((num_slots,), np.int32)
        self._host_limits = np.zeros((num_slots,), np.int32)

        cfg = model.cfg.talker
        dtype = model.talker_params["norm"].dtype
        b, device = num_slots, self.device
        with graphs.device_lock:
            kc, vc = alloc_kv_cache(cfg, b, self.prefill_bucket + max_new_tokens, dtype, device,
                                    kv_int8=model.kv_int8)

            def full(value, dtype):
                return torch.full((b,), value, dtype=dtype, device=device)

            self._state = DecodeState(
                token=full(0, torch.int64),
                hidden=torch.zeros((b, cfg.hidden_size), dtype=dtype, device=device),
                k_cache=kc, v_cache=vc,
                presence=torch.zeros((b, cfg.vocab_size), dtype=torch.bool, device=device),
                eos=full(True, torch.bool),  # every slot starts idle
                num_gen=full(0, torch.int32),
                prefix_len=full(self.prefill_bucket, torch.int32),
                n_real=full(self.prefill_bucket, torch.int32),
                valid_from=full(0, torch.int32),
                generator=torch.Generator(device=device).manual_seed(0),
            )
            self._trailing = torch.zeros((b, trailing_cap, cfg.hidden_size), dtype=dtype,
                                         device=device)
            self._limits = full(0, torch.int32)
            # Every sampling control, the talker's and the sub-talker's, is
            # per row: requests of different controls share one program.
            self._vec = VecSampling.broadcast(SamplingConfig(), b, device)
            self._st_vec = VecSampling.broadcast(SamplingConfig(), b, device)
        # The static configs only name the program when the rows carry theirs.
        self._static_sampling = (SamplingConfig(), SamplingConfig())
        self._slot_req: Dict[int, _SlotRequest] = {}
        self._slot_codes: Dict[int, List[np.ndarray]] = {}

        self._queue: "queue.Queue[Optional[_SlotRequest]]" = queue.Queue()
        self._req_by_future: Dict[int, _SlotRequest] = {}
        # The segment dispatched but not yet read (double-buffered dispatch).
        self._inflight = None
        self._running = False
        self._worker = threading.Thread(target=self._run, daemon=True)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ContinuousBatchingEngine":
        self._running = True
        self._worker.start()
        return self

    def stop(self):
        self._running = False
        self._queue.put(None)
        self._worker.join(timeout=60)

    # -- API ---------------------------------------------------------------

    def submit_prompt(self, prompt: Prompt, params: GenerationParams,
                      stream_callback=None, ref_codes=None,
                      timeout_s: Optional[float] = None) -> "Future[np.ndarray]":
        if prompt.embeds.shape[0] > self.prefill_bucket:
            raise ValueError(
                f"prompt length {prompt.embeds.shape[0]} exceeds the engine's "
                f"prefill bucket {self.prefill_bucket}")
        if prompt.trailing_text.shape[0] + 1 > self.trailing_cap:
            raise ValueError("trailing text exceeds trailing_cap")
        req = _SlotRequest(prompt, params, stream_callback=stream_callback)
        if timeout_s is not None:
            req.deadline = time.monotonic() + timeout_s
        if ref_codes is not None:
            req.ref_codes = icl_ref_codes(ref_codes, self.model.cfg.talker.num_code_groups
                                          ).astype(np.int32)
            req.ref_frames = req.ref_codes.shape[0]
        self._req_by_future[id(req.future)] = req
        self._queue.put(req)
        return req.future

    def cancel(self, future: "Future[np.ndarray]") -> bool:
        """Cancel a submitted request, queued or mid-decode. Its slot is
        reclaimed at the next segment boundary and the future resolves with
        CancelledError. False for unknown or finished futures."""
        req = self._req_by_future.get(id(future))
        if req is None or req.future.done():
            return False
        req.cancelled = True
        return True

    def submit_text(self, text: str, speaker=None, language="auto",
                    **gen_kwargs) -> "Future[np.ndarray]":
        ids = self.model._tokenize(self.model.build_assistant_text(text))
        return self.submit_ids(ids, speaker=speaker, language=language, **gen_kwargs)

    def submit_ids(self, ids, speaker=None, language="auto", *,
                   speaker_embed=None, ref_ids=None, ref_codes=None,
                   instruct_ids=None, non_streaming=False,
                   stream_callback=None, timeout_s=None, **gen_kwargs
                   ) -> "Future[np.ndarray]":
        """The whole prompt surface (custom voice, voice design, voice clone
        with ICL), as ``ServingEngine.submit_ids``."""
        req_max_new = gen_kwargs.pop("max_new_tokens", None)
        if req_max_new is not None and req_max_new > self.max_new_tokens:
            # Rejected rather than cut to the engine's frame-budget ceiling.
            raise ValueError(
                f"max_new_tokens={req_max_new} exceeds the engine ceiling "
                f"{self.max_new_tokens} (set ContinuousBatchingEngine("
                "max_new_tokens=…) at construction)")
        params = self.model._merge_params(
            max_new_tokens=req_max_new or self.max_new_tokens, **gen_kwargs)
        prompt = _build_prompt(self.model, ids, language=language, speaker=speaker,
                               speaker_embed=speaker_embed, instruct_ids=instruct_ids,
                               ref_ids=ref_ids, ref_codes=ref_codes,
                               non_streaming=non_streaming)
        return self.submit_prompt(prompt, params, stream_callback=stream_callback,
                                  ref_codes=ref_codes, timeout_s=timeout_s)

    # -- internals ---------------------------------------------------------

    def _admit(self, slot: int, req: _SlotRequest) -> None:
        params = req.params
        # The smallest bucket the prompt fits (submit_prompt checked the largest).
        plen = req.prompt.embeds.shape[0]
        bucket = next(b for b in self.prefill_buckets if plen <= b)
        self.stats["bucket_admits"][bucket] += 1
        model = self.model
        embeds, mask, trailing, _ = batch_prompts([req.prompt], bucket=bucket)
        dtype = model.talker_params["norm"].dtype
        sub = init_decode(
            model.talker_params, model.cfg.talker, embeds.to(dtype), mask,
            sampling=self._static_sampling[0],
            # Token 0 honours the request's own controls.
            vec_sampling=VecSampling.broadcast(params.talker_sampling(), 1, self.device),
            max_cache_len=self.prefill_bucket + self.max_new_tokens,
            generator=_request_generator(self.device, params.seed, self.stats["requests"]),
            kv_int8=model.kv_int8,
        )
        limit = min(params.max_new_tokens, self.max_new_tokens)
        _insert_slot(self._state, self._trailing, self._limits, self._vec, self._st_vec, slot,
                     sub, trailing[0].to(dtype), limit,
                     VecSampling.host_row(params.talker_sampling()),
                     VecSampling.host_row(params.subtalker_sampling()))
        self._slot_req[slot] = req
        self._host_gen[slot] = 0  # a fresh prefill: no frame generated yet
        self._host_limits[slot] = limit
        self._slot_codes[slot] = [req.ref_codes] if req.ref_codes is not None else []
        req.emitted_frames = req.ref_frames
        self.stats["requests"] += 1

    def _stream_emit(self, req: _SlotRequest, codes, done: bool) -> None:
        """Decode and emit a slot's fresh frames: a fixed window of left
        context + one segment (right-padded; the codec is causal, so the
        padding never reaches the emitted part), one codec program for the
        engine's life. Works on the captured (req, codes): the slot may have
        been admitted again since."""
        total = sum(c.shape[0] for c in codes)
        fresh = total - req.emitted_frames
        if fresh <= 0:
            if done:
                req.stream_callback(np.zeros((0,), np.float32), True)
            return
        dec_cfg = self.model.cfg.codec.decoder
        nq = dec_cfg.num_quantizers
        up = self.model.cfg.codec.decode_upsample_rate
        merged = np.concatenate(codes, axis=0)[:, :nq]
        ctx = min(self.stream_context_frames, req.emitted_frames)
        window = np.zeros((1, self.stream_context_frames + self.segment_frames, nq), np.int64)
        window[0, : ctx + fresh] = merged[req.emitted_frames - ctx:]
        wav = _codec_window(self.model.codec_params, dec_cfg,
                            torch.as_tensor(window, device=self.device))
        req.emitted_frames = total
        req.stream_callback(wav[0, ctx * up: (ctx + fresh) * up].cpu().numpy(), done)

    def _abort(self, slot: int, exc: Exception) -> None:
        """Reclaim a cancelled or expired slot: zero its frame budget (the
        frame program stops working on the row) and resolve its future with
        ``exc``. The other slots are untouched."""
        req = self._slot_req.pop(slot)
        self._slot_codes.pop(slot, None)
        self._limits[slot] = 0
        self._host_limits[slot] = 0
        self._req_by_future.pop(id(req.future), None)
        if req.stream_callback is not None:
            try:
                req.stream_callback(np.zeros((0,), np.float32), True)
            except Exception:  # a client's callback must not stop the engine
                pass
        if not req.future.done():
            req.future.set_exception(exc)

    def _finish_one(self, req: _SlotRequest, codes) -> None:
        """Resolve a finished request from the captured (req, codes): its
        waveform at batch 1, the length rounded up to a bucket, less the
        reference frames' share."""
        if req.stream_callback is not None:
            if not req.future.done():
                req.future.set_result(np.zeros((0,), np.float32))
            return
        g = self.model.cfg.talker.num_code_groups
        merged = np.concatenate(codes, axis=0) if codes else np.zeros((0, g), np.int32)
        wav = self.model.decode_codes([merged], bucket=max(32, self.segment_frames))[0]
        up = self.model.cfg.codec.decode_upsample_rate
        req.future.set_result(wav[req.ref_frames * up:])

    def _resolve_pending(self, work) -> None:
        """Run a slot's emit and finish items, each timed and each failure
        resolving only its own request."""
        for kind, req, codes, done in work:
            try:
                t0 = time.perf_counter()
                if kind == "emit":
                    if req.future.done():
                        continue  # cancelled since
                    self._stream_emit(req, codes, done)
                    self.stats["time_emit_s"] += time.perf_counter() - t0
                else:
                    self._finish_one(req, codes)
                    self.stats["time_finish_s"] += time.perf_counter() - t0
            except Exception as exc:
                if not req.future.done():
                    req.future.set_exception(exc)

    def _run(self):
        try:
            self._run_loop()
        finally:
            # Shutdown drain, on every exit path (stop() can clear _running
            # with a segment in flight): read it, so that slots which
            # finished in it resolve normally, then fail whatever is left
            # rather than leave a client waiting on a future no thread will
            # complete.
            with graphs.device_lock:
                try:
                    if self._inflight is not None:
                        self._process_segment(self._inflight)
                        self._inflight = None
                except Exception:
                    pass
                for slot in list(self._slot_req):
                    try:
                        self._abort(slot, CancelledError("engine stopped"))
                    except Exception:
                        pass
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                if req is None:
                    continue
                self._req_by_future.pop(id(req.future), None)
                if not req.future.done():
                    req.future.set_exception(CancelledError("engine stopped"))

    def _run_loop(self):
        while self._running:
            # Admit queued requests into free slots.
            free = [i for i in range(self.num_slots) if i not in self._slot_req]
            # Wait only when idle with nothing dispatched and unread.
            block = len(free) == self.num_slots and self._inflight is None
            while free:
                try:
                    req = self._queue.get(block=block, timeout=1.0 if block else 0)
                except queue.Empty:
                    break
                if req is None:
                    return  # _run's drain reads any segment in flight
                block = False
                if req.cancelled:
                    self._req_by_future.pop(id(req.future), None)
                    if not req.future.done():
                        req.future.set_exception(CancelledError())
                    continue
                try:
                    t0 = time.perf_counter()
                    with graphs.device_lock:
                        self._admit(free.pop(0), req)
                    self.stats["time_admit_s"] += time.perf_counter() - t0
                except Exception as exc:
                    # A poisoned request resolves its own future; serving goes on.
                    self._req_by_future.pop(id(req.future), None)
                    if not req.future.done():
                        req.future.set_exception(exc)
            # Reap cancelled and expired slots before a segment is spent on them.
            now = time.monotonic()
            with graphs.device_lock:
                for slot, req in list(self._slot_req.items()):
                    if req.cancelled:
                        self._abort(slot, CancelledError())
                    elif req.deadline is not None and now > req.deadline:
                        frames = sum(c.shape[0] for c in self._slot_codes.get(slot, []))
                        self._abort(slot, TimeoutError(
                            "request exceeded its deadline (timeout_s) after "
                            f"{frames} generated frames"))
            if not self._slot_req and self._inflight is None:
                continue

            # Double-buffered dispatch: queue the next segment, then read the
            # one in flight. A slot that stopped in the unread segment rides
            # the next one frozen; its frames there are dropped (identity
            # check). The codes are those of a loop that reads each segment
            # at once: only the reads move.
            dispatched = None
            if self._slot_req:
                t_seg = time.perf_counter()
                with graphs.device_lock:
                    # with_report: this segment's num_gen and eos, in tensors
                    # that the next segment's replays do not overwrite.
                    self._state, seg_codes, report = decode_segment(
                        self.model.talker_params, self.model.subtalker_params,
                        self.model.cfg.talker, self._state, self._trailing,
                        sampling=self._static_sampling[0],
                        st_sampling=self._static_sampling[1],
                        segment=self.segment_frames, step_limit=self._limits,
                        vec_sampling=self._vec, st_vec_sampling=self._st_vec,
                        with_report=True,
                    )
                # Who took part, by identity: when this segment is read, a
                # slot may hold another request.
                dispatched = (dict(self._slot_req), report[0], report[1], seg_codes)
                self.stats["time_segment_s"] += time.perf_counter() - t_seg
                self.stats["segments"] += 1
            if self.sync_dispatch and dispatched is not None:
                t_seg = time.perf_counter()
                with graphs.device_lock:
                    self._process_segment(dispatched)
                self.stats["time_segment_s"] += time.perf_counter() - t_seg
                dispatched = None
            if self._inflight is not None:
                t_seg = time.perf_counter()
                with graphs.device_lock:
                    self._process_segment(self._inflight)
                self.stats["time_segment_s"] += time.perf_counter() - t_seg
            self._inflight = dispatched

    def _process_segment(self, inflight) -> None:
        """Read one dispatched segment's results and keep the books."""
        participants, num_gen, eos, seg = inflight
        new_gen = num_gen.cpu().numpy()
        eos = eos.cpu().numpy()
        seg = seg.cpu().numpy().astype(np.int32)
        limits = self._host_limits
        for slot, req in participants.items():
            if self._slot_req.get(slot) is not req:
                # Aborted, finished or admitted again since the dispatch:
                # these frames belong to an earlier occupant.
                self.stats["stale_skips"] += 1
                continue
            fresh = int(new_gen[slot]) - int(self._host_gen[slot])
            self._host_gen[slot] = int(new_gen[slot])
            done = bool(eos[slot]) or int(new_gen[slot]) >= int(limits[slot])
            if done and not bool(eos[slot]) and fresh > 0:
                # A slot that ran out of budget drops its final frame, as
                # generate_codes does (the reference never expands the last
                # codebook-0 token's groups).
                fresh -= 1
            if fresh > 0:
                self._slot_codes[slot].append(seg[slot, :fresh])
                self.stats["frames"] += fresh
            work = []
            if req.stream_callback is not None and (fresh > 0 or done):
                work.append(("emit", req, self._slot_codes[slot], done))
            if done:
                self._slot_req.pop(slot)
                codes = self._slot_codes.pop(slot)
                self._req_by_future.pop(id(req.future), None)
                work.append(("finish", req, codes, True))
            if work:
                self._resolve_pending(work)


def _build_prompt(model: Qwen3TTSModel, ids, *, ref_codes=None, **kw) -> Prompt:
    """``build_prompt`` on the model's device, under ``graphs.device_lock``
    (its embedding gathers run on the card, beside an engine's worker). ICL
    reference codes are cut to the talker's groups first
    (``icl_ref_codes``: fewer groups raise)."""
    if ref_codes is not None:
        ref_codes = icl_ref_codes(ref_codes, model.cfg.talker.num_code_groups)
    with graphs.device_lock:
        return build_prompt(model.talker_params, model.cfg, np.asarray(ids, np.int64),
                            ref_codes=ref_codes, st_params=model.subtalker_params, **kw)
