"""Streamed serving: an open loop of requests into one in-process
``ContinuousBatchingEngine``, the server's continuous deployment
(``server.py --continuous --serving-int8 --kv-int8``), every request
streaming through its ``stream_callback``.

One client thread submits each request at its due time (stratified
Poisson arrivals at the cell's fixed rate, ``traffic.schedule``). A ramp runs
before the window so that the slot pool is in its steady state when the
window opens. Requests due inside the window are the ones counted. After the
window no request is submitted; the run waits, to a deadline, for the
counted requests' first chunks and for the greedy ones to finish.

Times are the host's ``perf_counter`` at the client's callback. A request's
first-chunk latency runs from its due time on the schedule, so a client
that runs late, or a stall, counts against the system.
"""

from __future__ import annotations

import statistics
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import sut
import roofline
import subwindow as tracing
import traffic


def p95(values) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 95))


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Driver:
    kind = "serve"

    def __init__(self, ctx):
        self.ctx = ctx
        self.mix = ctx.mix
        self.cfg = ctx.cfg

    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        mix, ctx = self.mix, self.ctx
        # The weights live in the model alone: the reference draws them
        # again from the seed once the window is over.
        self.model = sut.model(ctx.tts, sut.cell_weights(ctx), mix["int8"])
        self.up = ctx.tts.codec.decode_upsample_rate
        self.served: Dict[int, np.ndarray] = {}
        self.spans = tracing.Spans()
        self.start_engine()

    def start_engine(self) -> None:
        """A new engine on the model, started and warmed up: the frame
        program at the pool's batch, the prefill at its bucket and the
        stream's codec window, through two requests (one greedy, one
        sampled) of two segments each. The model's captured programs are
        reused by a later engine of the same shapes."""
        from qwen_tts_tpu_torch.continuous import ContinuousBatchingEngine

        mix, ctx = self.mix, self.ctx
        eng = mix["engine"]
        self.engine = ContinuousBatchingEngine(
            self.model, num_slots=eng["slots"], segment_frames=eng["segment_frames"],
            max_new_tokens=eng["ceiling"], prefill_bucket=eng["prefill_bucket"],
            trailing_cap=eng["trailing_cap"], stream_context_frames=eng["context_frames"])
        self._record(self.engine)
        self.engine.start()
        warm = traffic.block(mix, self.cfg, ctx.seed, 10 ** 6)[:2]
        warm[0]["greedy"], warm[1]["greedy"] = True, False
        futures = []
        for r in warm:
            r["frames"] = eng["segment_frames"] + 3
            futures.append(self._submit(r, lambda wav, done: None))
        for f in futures:
            f.result(timeout=600)
        _sync()

    def _record(self, engine) -> None:
        """Record, for the check, the slot each request is admitted to and
        the codes the engine finishes it with. The engine hands neither to
        its client (a streamed request's future resolves to no audio), so
        these are the two private methods that the benchmark wraps in every
        run; each still runs as it is."""
        admit, finish = engine._admit, engine._finish_one
        self.slots: Dict[int, int] = {}

        def admitting(slot, req):
            self.slots[id(req.future)] = int(slot)
            admit(slot, req)

        def finishing(req, codes):
            self.served[id(req.future)] = (np.concatenate(codes) if codes
                                           else np.zeros((0, 1), np.int32))
            finish(req, codes)

        engine._admit, engine._finish_one = admitting, finishing

    def _spans(self, engine) -> None:
        """Host spans around the engine's device calls, for the traced run
        alone."""
        for name, label in (("_admit", "engine admit (prefill, slot)"),
                            ("_segment", "engine segment dispatch"),
                            ("_process_segment", "engine segment read"),
                            ("_stream_emit", "engine emit (codec window)")):
            setattr(engine, name, self.spans.wrap(label, getattr(engine, name)))

    def _submit(self, r: dict, callback):
        mix = self.mix
        sampled = not r["greedy"]
        return self.spans.wrap("client submit (prompt on the card)", self.engine.submit_ids)(
            r["text_ids"], speaker=r["speaker"], language=r["language"],
            max_new_tokens=r["frames"] + 1, min_new_tokens=r["frames"] + 2,
            do_sample=sampled, top_k=mix["top_k"], top_p=1.0, temperature=mix["temperature"],
            repetition_penalty=mix["repetition_penalty"], subtalker_dosample=sampled,
            subtalker_top_k=mix["top_k"], subtalker_top_p=1.0,
            subtalker_temperature=mix["temperature"], seed=r["seed"],
            stream_callback=callback)

    # -- the window --------------------------------------------------------

    def run(self, seconds: float, trace: bool) -> dict:
        mix, ctx = self.mix, self.ctx
        reqs = traffic.schedule(mix, self.cfg, ctx.seed, seconds)
        chunks: List[List] = [[] for _ in reqs]   # (time, samples) per callback
        audio: List[List] = [[] for _ in reqs]    # streamed samples
        futures: List = [None] * len(reqs)
        submitted = [None] * len(reqs)
        errors: List[tuple] = []  # (request, what it raised)
        ramp = float(mix["ramp_s"])
        t_launch = time.perf_counter()
        w0, w1 = t_launch + ramp, t_launch + ramp + seconds
        marks = {}

        def callback(i):
            def cb(wav, done):
                chunks[i].append((time.perf_counter(), int(wav.shape[0]), bool(done)))
                if wav.shape[0]:
                    audio[i].append(np.array(wav, np.float32))
            return cb

        def client():
            for i, r in enumerate(reqs):
                due = w0 + r["due"]
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                submitted[i] = time.perf_counter()
                try:
                    futures[i] = self._submit(r, callback(i))
                except Exception as exc:  # a refused request is a failed one
                    errors.append((i, repr(exc)))

        def snapshot(key):
            marks[key] = (time.perf_counter(), dict(self.engine.stats))

        def waiting():
            # Requests submitted that have had no chunk yet (queued or in
            # their first segments), as the client sees them.
            return sum(1 for i, s in enumerate(submitted) if s is not None and not chunks[i]
                       and not (futures[i] is not None and futures[i].done()))

        if trace:
            self._spans(self.engine)
        thread = threading.Thread(target=client, daemon=True)
        thread.start()
        self._sleep_until(w0)
        snapshot("w0")
        backlog0 = waiting()
        # The traced run's sub-window opens late in the window: the
        # profiler slows the host, so the engine's counters are read over
        # the window up to it.
        profiles = self._trace(w0, w1, lambda: snapshot("trace")) if trace else None
        self._sleep_until(w1)
        snapshot("w1")
        backlog = waiting()
        thread.join(timeout=120)
        counted = [i for i, r in enumerate(reqs) if r["due"] >= 0]
        deadline = w1 + float(mix["drain_s"])
        for i in counted:
            while (not chunks[i] and time.perf_counter() < deadline
                   and not (futures[i] is not None and futures[i].done())):
                time.sleep(0.01)
            if reqs[i]["greedy"] and futures[i] is not None:
                try:
                    futures[i].result(timeout=max(0.0, deadline - time.perf_counter()))
                except Exception as exc:
                    errors.append((i, repr(exc)))
        self.engine.stop()
        return {"reqs": reqs, "chunks": chunks, "audio": audio, "futures": futures,
                "submitted": submitted, "counted": counted, "w0": w0, "w1": w1,
                "deadline": deadline, "marks": marks, "errors": errors,
                "backlog": (backlog0, backlog), "profiles": profiles}

    @staticmethod
    def _sleep_until(t: float) -> None:
        while True:
            wait = t - time.perf_counter()
            if wait <= 0:
                return
            time.sleep(min(wait, 0.05))

    def _trace(self, w0: float, w1: float, opening) -> Optional[dict]:
        """Profile sub-windows of the window between the engine's device
        calls (holding ``graphs.device_lock`` while it opens and closes
        one, after a synchronize), until one kept every launch the counters
        say ran, at most three."""
        from qwen_tts_tpu_torch import graphs

        span = float(self.mix["trace_s"])
        start = w0 + 0.6 * (w1 - w0)
        self._sleep_until(start)
        opening()
        notes = []
        for attempt in range(3):
            self._sleep_until(start + attempt * (span + 1.0))
            prof = tracing.Profile(self.spans)
            with graphs.device_lock:
                _sync()
                before = prof.start()
            time.sleep(span)
            with graphs.device_lock:
                _sync()
                after = tracing.counters()
                prof.stop()
            red = prof.reduce()
            missing = tracing.complete(red, tracing.delta(before, after),
                                       ("int8_matmul", "subtalker_step", "decode_attention_int8"))
            if missing is None:
                return {"red": red, "notes": notes}
            notes.append(missing)
            print(f"trace: sub-window {attempt + 1} lost kernels ({missing}); taken again",
                  file=sys.stderr)
        return {"red": red, "notes": notes, "incomplete": True}

    # -- readings ----------------------------------------------------------

    def first_chunks(self, rec: dict):
        """(latency ms of each counted request, failed indices)."""
        lat, failed = [], []
        for i in rec["counted"]:
            due = rec["w0"] + rec["reqs"][i]["due"]
            first = next((t for t, n, _ in rec["chunks"][i] if n > 0), None)
            if first is None:
                failed.append(i)
                first = rec["deadline"]
            lat.append((first - due) * 1e3)
        return lat, failed

    def gaps(self, rec: dict) -> List[float]:
        """Every gap between consecutive audio chunks of any stream whose
        later chunk came inside the window (ms)."""
        out = []
        for ch in rec["chunks"]:
            times = [t for t, n, _ in ch if n > 0]
            out += [(b - a) * 1e3 for a, b in zip(times, times[1:]) if rec["w0"] <= b <= rec["w1"]]
        return out

    def metrics(self, rec: dict) -> dict:
        lat, failed = self.first_chunks(rec)
        gaps = self.gaps(rec)
        late = [(s - (rec["w0"] + r["due"])) * 1e3 for r, s in zip(rec["reqs"], rec["submitted"])
                if s is not None and r["due"] >= 0]
        w = rec["w1"] - rec["w0"]
        frames = sum(n for ch in rec["chunks"] for t, n, _ in ch
                     if rec["w0"] <= t <= rec["w1"]) / self.up
        print(f"serve: {len(rec['counted'])} requests due in the window ({len(failed)} without a "
              f"first chunk by the deadline), first chunk median "
              f"{statistics.median(lat):.1f} ms p95 {p95(lat):.1f} ms; {len(gaps)} chunk gaps, "
              f"median {statistics.median(gaps) if gaps else 0:.1f} ms p95 "
              f"{p95(gaps) if gaps else 0:.1f} ms; audio streamed in the window "
              f"{frames * 0.08:.1f} s ({frames * 0.08 / w:.2f} s/s); client late median "
              f"{statistics.median(late) if late else 0:.2f} ms max {max(late) if late else 0:.2f} "
              f"ms; requests without a first chunk at the window's start and end {rec['backlog']}; errors {len(rec['errors'])}",
              file=sys.stderr)
        for i, e in rec["errors"][:5]:
            print(f"serve: request {i}: {e}", file=sys.stderr)
        out = {"first_chunk_p95_ms": (p95(lat), "ms")}
        if gaps:
            out["chunk_gap_p95_ms"] = (p95(gaps), "ms")
        return out

    def attempted_failed(self, rec: dict):
        _, failed = self.first_chunks(rec)
        errs = {i for i, _ in rec["errors"]}
        counted = set(rec["counted"])
        return len(rec["counted"]), len(set(failed) | (errs & counted))

    def layer(self, rec: dict) -> dict:
        """What the per-layer readers read."""
        end = "trace" if "trace" in rec["marks"] else "w1"
        (t0, s0), (t1, s1) = rec["marks"]["w0"], rec["marks"][end]
        emits = sum(1 for ch in rec["chunks"] for t, _, _ in ch if t0 <= t <= t1)
        t = self.cfg["talker_config"]
        plen = sut.prompt_len(self.cfg)
        flops = 0
        for ch in rec["chunks"]:
            done = 0
            for at, n, _ in ch:
                f = n // self.up
                if t0 <= at <= t1:
                    flops += roofline.frames_flops(t, plen + done, f)
                done += f
        return {"kind": "serve", "cfg": self.cfg, "mix": self.mix,
                "stats": {k: s1[k] - s0[k] for k in ("requests", "segments", "frames",
                                                        "time_admit_s", "time_segment_s",
                                                        "time_emit_s")},
                "emits": emits, "flops": flops, "trace": rec["profiles"]}

    def served_sample(self, rec: dict) -> List[dict]:
        """The requests due in the window that finished: every greedy one,
        and of the sampled ones a seeded draw of the mix's
        ``check_sampled_per_half`` from each half of the slot pool."""
        half = self.mix["engine"]["slots"] // 2
        greedy, sampled = [], ([], [])
        for i in rec["counted"]:
            fut = rec["futures"][i]
            if (fut is None or not fut.done() or fut.exception() is not None
                    or id(fut) not in self.served):
                continue
            if rec["reqs"][i]["greedy"]:
                greedy.append(i)
            elif id(fut) in self.slots:
                sampled[int(self.slots[id(fut)] >= half)].append(i)
        gen = traffic.rng(self.ctx.seed, 3)
        n = self.mix["check_sampled_per_half"]
        pick = greedy + [side[j] for side in sampled for j in gen.permutation(len(side))[:n]]
        out = []
        for i in pick:
            r, fut = rec["reqs"][i], rec["futures"][i]
            slot = self.slots.get(id(fut))
            out.append({"text_ids": r["text_ids"], "speaker": r["speaker"],
                        "language": r["language"], "codes": self.served[id(fut)],
                        "greedy": r["greedy"], "top_k": self.mix["top_k"],
                        "temperature": self.mix["temperature"],
                        "subtalker_top_k": self.mix["top_k"],
                        "subtalker_temperature": self.mix["temperature"],
                        "half": None if slot is None else int(slot >= half),
                        "repetition_penalty": self.mix["repetition_penalty"],
                        "min_new_tokens": r["frames"] + 2,
                        "audio": np.concatenate(rec["audio"][i]) if rec["audio"][i]
                        else np.zeros(0, np.float32),
                        "codec": {"mode": "stream",
                                  "chunks": [n // self.up for _, n, _ in rec["chunks"][i] if n],
                                  "context": self.mix["engine"]["context_frames"],
                                  "segment": self.mix["engine"]["segment_frames"]}})
        return out

    def missing_greedy(self, rec: dict) -> int:
        """Greedy requests due in the window that never finished."""
        n = 0
        for i in rec["counted"]:
            fut = rec["futures"][i]
            if rec["reqs"][i]["greedy"] and (fut is None or not fut.done()
                                              or fut.exception() is not None):
                n += 1
        return n

    def release(self) -> None:
        sut.release(self.model)
        del self.engine, self.model
