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

**Tensor parallelism**, by the continuous engine's protocol
(``continuous.py``). With a model whose talker config holds a tp placement,
every rank of the tp group must make the same device calls in the same
order, and a window's makeup depends on time (``max_wait_ms``) and on the
queue. So tp rank 0 is the **leader**: it alone has the queue, the futures,
the held requests, cancellation, the window's timing and the codec decode.
Before each window's decode it broadcasts one command naming it and its host
inputs (the prompts' tensors on the CPU, the window's ``GenerationParams``,
the rows' budgets, the batch padding, the ceiling, the trailing bucket), over
the continuous engine's command group (``continuous._command_channel``);
while idle it sends a heartbeat at least every ``IDLE_WAIT_S`` seconds, and
its worker's last act is ``("stop",)``. Every other rank is a **follower**:
``follow()`` replays each window's decode on its own shards and drops the
codes (the codec is whole on every rank; only the leader decodes waveforms)
until that stop. A gloo tp group runs the frames eagerly, an NCCL one
captures them (``generate._decode``). With no placement, or a tp group of
one rank, the engine is its own leader and broadcasts nothing. Under a dp x
tp mesh each tp group serves on its own.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import CancelledError, Future
from typing import Dict, List, Optional

import numpy as np
import torch.distributed as dist

from qwen_tts_tpu_torch import graphs
from qwen_tts_tpu_torch.continuous import (
    IDLE_WAIT_S,
    ContinuousBatchingEngine,
    _build_prompt,
    _command_channel,
)
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
        # failed_windows: windows whose decode raised (on a follower, its
        # replays; the leader resolves their futures with the exception).
        self.stats = {"requests": 0, "batches": 0, "frames": 0, "failed_windows": 0}
        channel = _command_channel(model.cfg.talker)
        self._channel, self._leader_rank, self.is_leader = (
            channel if channel is not None else (None, None, True))
        self._channel_failed = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServingEngine":
        if not self.is_leader:
            raise RuntimeError("a follower rank serves through follow(), not start()")
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
        if not self.is_leader:
            raise RuntimeError("requests go to the tp group's leader (tp rank 0)")
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
            if self._held:
                first = self._held.pop(0)
            else:
                try:
                    first = self._queue.get(timeout=IDLE_WAIT_S)
                except queue.Empty:
                    try:
                        self._tell(("idle",))  # the followers' heartbeat
                    except Exception:  # the group is gone: the next window's decode fails
                        pass
                    continue
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
        try:
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
                    self.stats["failed_windows"] += 1
                    for req in batch:
                        self._req_by_future.pop(id(req.future), None)
                        if not req.future.done():
                            req.future.set_exception(exc)
        finally:
            try:
                self._tell(("stop",))
            except Exception:  # the group is gone: nobody to stop
                pass

    # -- the tp group ------------------------------------------------------

    # Leader: broadcast a command to the followers before the device call it
    # names; the continuous engine's, on the same attributes (``_channel``,
    # ``_leader_rank``, ``_channel_failed``).
    _tell = ContinuousBatchingEngine._tell

    def follow(self) -> None:
        """Follower: replay the leader's windows on this rank's shards until
        its ``stop()``. Each wait for a command is bounded by the command
        group's timeout (``continuous.COMMAND_TIMEOUT``; the idle leader beats
        every ``IDLE_WAIT_S`` seconds). A window whose decode raises here
        raises on the leader too (the same inputs reach the same ops, and so
        the same collectives, on every rank): the leader resolves its futures
        with it and this rank goes on to the next command."""
        if self.is_leader:
            raise RuntimeError("the leader serves through start(); follow() is a follower's")
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=self._leader_rank, group=self._channel)
            command = box[0]
            if command[0] == "stop":
                return
            if command[0] != "window":
                continue  # the heartbeat
            _, prompts, params, limits, pad_to, ceiling, trailing_bucket = command
            device = self.model.device
            try:
                with graphs.device_lock:
                    self._decode_window([Prompt(*(t.to(device) for t in p)) for p in prompts],
                                        params, limits, pad_to, ceiling, trailing_bucket)
            except Exception:  # the leader resolves the window's futures with it
                self.stats["failed_windows"] += 1

    def _decode_window(self, prompts: List[Prompt], params: GenerationParams, limits,
                       pad_to: int, ceiling: int, trailing_bucket: int):
        """A window's decode, the same call on every rank of a tp group."""
        return self.model.generate_codes_from_prompts(
            prompts, params, step_limit=limits, max_new_ceiling=ceiling, pad_batch_to=pad_to,
            trailing_bucket=trailing_bucket)

    # -- internals ---------------------------------------------------------

    def _generate(self, batch: List[TTSRequest]):
        """One window: the decode at the engine's ceiling with each row's
        own budget, the batch padded to a power of two (at most max_batch)
        and the trailing text rounded to 16 rows, so that every window of one
        config replays one frame program; then the codec at a bucketed
        length. Returns the waveforms and the frames generated. On a tp group
        the decode's command goes to the followers first."""
        ceiling = self.max_new_tokens
        params = dataclasses.replace(batch[0].params, max_new_tokens=ceiling)
        limits = [min(r.params.max_new_tokens, ceiling) for r in batch]
        pad_to = min(1 << (len(batch) - 1).bit_length(), self.max_batch)
        prompts = [r.prompt for r in batch]
        self._tell(("window", [Prompt(*(t.cpu() for t in p)) for p in prompts], params,
                    limits, pad_to, ceiling, 16))
        codes, _ = self._decode_window(prompts, params, limits, pad_to, ceiling, 16)
        # ICL voice clone: the reference codes lead the codec decode; their
        # audio is cut after it.
        merged = [c if r.ref_codes is None else np.concatenate([r.ref_codes, c], axis=0)
                  for r, c in zip(batch, codes)]
        cut = [0 if r.ref_codes is None else r.ref_codes.shape[0] for r in batch]
        wavs = self.model.decode_codes(merged, bucket=32)
        up = self.model.cfg.codec.decode_upsample_rate
        return [w[k * up:] for w, k in zip(wavs, cut)], sum(c.shape[0] for c in codes)
