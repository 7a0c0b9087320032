"""Window-batching serving engine (PyTorch counterpart of
``qwen_tts_tpu/serving.py``).

Requests queue up; a worker groups them (up to ``max_batch``, waiting at most
``max_wait_ms``), runs one batched generation and resolves each request's
future with its trimmed waveform. Weight reads are shared by the whole batch.

A window runs under one set of sampling controls (one captured frame
program each), so the scheduler groups the queue by them and holds a request
of other controls for a later window: no request runs under another's
settings. Budgets may differ within a window: it decodes at the engine's
ceiling with a per-row frame budget, pads its batch to a power of two and
rounds the trailing text to 16 rows, so every window of one config replays
one frame program. For per-request controls in one program use the
continuous engine (``continuous.py``).

The worker does the card work under ``graphs.device_lock``; a submitting
thread holds it only while it builds its prompt.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import CancelledError, Future
from typing import Dict, List, Optional

import numpy as np

from qwen_tts_tpu_torch import graphs
from qwen_tts_tpu_torch.continuous import _build_prompt
from qwen_tts_tpu_torch.generate import GenerationParams, Prompt, icl_ref_codes
from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel


@dataclasses.dataclass
class TTSRequest:
    prompt: Prompt
    params: GenerationParams
    future: "Future[np.ndarray]" = dataclasses.field(default_factory=Future)
    enqueued_at: float = dataclasses.field(default_factory=time.perf_counter)
    cancelled: bool = False
    # Voice clone (ICL): the reference codes lead the codec decode and their
    # share of the waveform is cut after it.
    ref_codes: Optional[np.ndarray] = None


class ServingEngine:
    def __init__(
        self,
        model: Qwen3TTSModel,
        *,
        max_batch: int = 8,
        max_wait_ms: float = 30.0,
        max_new_tokens: int = 512,
    ):
        self.model = model
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.max_new_tokens = max_new_tokens
        self._queue: "queue.Queue[Optional[TTSRequest]]" = queue.Queue()
        self._req_by_future: Dict[int, TTSRequest] = {}
        self._held: List[TTSRequest] = []  # other controls: a later window
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._running = False
        self.stats = {"requests": 0, "batches": 0, "frames": 0}

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServingEngine":
        self._running = True
        self._worker.start()
        return self

    def stop(self):
        self._running = False
        self._queue.put(None)
        self._worker.join(timeout=30)

    # -- API ---------------------------------------------------------------

    def submit_text(self, text: str, speaker: Optional[str] = None, language: str = "auto",
                    **gen_kwargs) -> "Future[np.ndarray]":
        ids = self.model._tokenize(self.model.build_assistant_text(text))
        return self.submit_ids(ids, speaker=speaker, language=language, **gen_kwargs)

    def submit_ids(
        self,
        ids: np.ndarray,
        speaker: Optional[str] = None,
        language: str = "auto",
        *,
        speaker_embed: Optional[np.ndarray] = None,
        ref_ids: Optional[np.ndarray] = None,
        ref_codes: Optional[np.ndarray] = None,
        instruct_ids: Optional[np.ndarray] = None,
        non_streaming: bool = False,
        **gen_kwargs,
    ) -> "Future[np.ndarray]":
        """The whole prompt surface: custom voice (speaker), voice design
        (instruct_ids), voice clone (speaker_embed x-vector, with ref_ids and
        ref_codes for ICL)."""
        req_max_new = gen_kwargs.pop("max_new_tokens", None)
        if req_max_new is not None and req_max_new > self.max_new_tokens:
            # The window decodes under the engine's ceiling: a larger budget
            # is rejected rather than cut.
            raise ValueError(
                f"max_new_tokens={req_max_new} exceeds the engine ceiling "
                f"{self.max_new_tokens} (set ServingEngine(max_new_tokens=…) "
                "at construction)")
        params = self.model._merge_params(
            max_new_tokens=req_max_new or self.max_new_tokens, **gen_kwargs)
        prompt = _build_prompt(self.model, ids, language=language, speaker=speaker,
                               speaker_embed=speaker_embed, instruct_ids=instruct_ids,
                               ref_ids=ref_ids, ref_codes=ref_codes,
                               non_streaming=non_streaming)
        rc = (None if ref_codes is None
              else icl_ref_codes(ref_codes, self.model.cfg.talker.num_code_groups).astype(np.int32))
        req = TTSRequest(prompt, params, ref_codes=rc)
        self._req_by_future[id(req.future)] = req
        self._queue.put(req)
        return req.future

    def cancel(self, future: "Future[np.ndarray]") -> bool:
        """Cancel a QUEUED request (it resolves with CancelledError when a
        window is assembled). A request inside a running window is not
        interrupted; the continuous engine reclaims slots mid-decode."""
        req = self._req_by_future.get(id(future))
        if req is None or req.future.done():
            return False
        req.cancelled = True
        return True

    # -- worker ------------------------------------------------------------

    def _collect_batch(self) -> List[TTSRequest]:
        def drop_if_cancelled(req):
            if req is not None and req.cancelled:
                self._req_by_future.pop(id(req.future), None)
                if not req.future.done():
                    req.future.set_exception(CancelledError())
                return True
            return False

        first = None
        while first is None:
            first = self._queue.get() if not self._held else self._held.pop(0)
            if first is None:
                return []
            if drop_if_cancelled(first):
                first = None
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_ms / 1e3
        while len(batch) < self.max_batch:
            if self._held:
                req = None
                for i, h in enumerate(self._held):
                    if self._window_key(h.params) == self._window_key(first.params):
                        req = self._held.pop(i)
                        break
                if req is None:
                    break  # only requests of other controls held: run what we have
                if drop_if_cancelled(req):
                    continue
                batch.append(req)
                continue
            timeout = deadline - time.perf_counter()
            if timeout <= 0:
                break
            try:
                req = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if req is None:
                break
            if drop_if_cancelled(req):
                continue
            if self._window_key(req.params) == self._window_key(first.params):
                batch.append(req)
            else:
                # Other sampling controls cannot share this window's program:
                # held for a later window, never run under this one's.
                self._held.append(req)
        return batch

    @staticmethod
    def _window_key(params: GenerationParams) -> GenerationParams:
        """Requests that differ only in max_new_tokens share a window (each
        row has its own budget under the ceiling)."""
        return dataclasses.replace(params, max_new_tokens=0)

    def _run(self):
        while self._running:
            batch = self._collect_batch()
            if not batch:
                continue
            try:
                with graphs.device_lock:
                    wavs, frames = self._generate(batch)
                for req, wav in zip(batch, wavs):
                    self._req_by_future.pop(id(req.future), None)
                    req.future.set_result(wav)
                self.stats["requests"] += len(batch)
                self.stats["batches"] += 1
                self.stats["frames"] += frames
            except Exception as exc:  # resolve the futures rather than wedge
                for req in batch:
                    self._req_by_future.pop(id(req.future), None)
                    if not req.future.done():
                        req.future.set_exception(exc)

    def _generate(self, batch: List[TTSRequest]):
        """One window: the decode at the engine's ceiling with each row's
        own budget, the batch padded to a power of two (at most max_batch)
        and the trailing text rounded to 16 rows, so that every window of one
        config replays one frame program; then the codec at a bucketed
        length. Returns the waveforms and the frames generated."""
        ceiling = self.max_new_tokens
        params = dataclasses.replace(batch[0].params, max_new_tokens=ceiling)
        limits = [min(r.params.max_new_tokens, ceiling) for r in batch]
        pad_to = 1 << (len(batch) - 1).bit_length()
        codes, _ = self.model.generate_codes_from_prompts(
            [r.prompt for r in batch], params, step_limit=limits, max_new_ceiling=ceiling,
            pad_batch_to=min(pad_to, self.max_batch), trailing_bucket=16)
        # ICL voice clone: the reference codes lead the codec decode; their
        # audio is cut after it.
        merged = [c if r.ref_codes is None else np.concatenate([r.ref_codes, c], axis=0)
                  for r, c in zip(batch, codes)]
        cut = [0 if r.ref_codes is None else r.ref_codes.shape[0] for r in batch]
        wavs = self.model.decode_codes(merged, bucket=32)
        up = self.model.cfg.codec.decode_upsample_rate
        return [w[k * up:] for w, k in zip(wavs, cut)], sum(c.shape[0] for c in codes)
