"""Offline batches: a closed loop of whole calls, the two halves of
``Qwen3TTSModel.generate_custom_voice`` on a batch of rows, back to back:
``generate_codes_from_prompts`` (every row with its own frame budget
through ``step_limit``, the cache and the captured frame sized for the
mix's ceiling) and then ``decode_codes``. Rows are padded to the longest,
as a batch job pays for. Calls start until the window's seconds have
passed; only whole calls count.

Sampling is one configuration a call: every ``greedy_every``-th call
(from the first) is greedy, the others sample with the upstream defaults.
The check reads every row of the window's first greedy call and, of its
first sampled call, a seeded draw of ``check_sampled_per_half`` rows from
each half of the batch.
"""

from __future__ import annotations

import statistics
import sys
import threading
import time
from typing import List, Optional

import numpy as np
import torch

import sut
import roofline
import subwindow as tracing
import traffic


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Driver:
    kind = "batch"

    def __init__(self, ctx):
        self.ctx = ctx
        self.mix = ctx.mix
        self.cfg = ctx.cfg
        self.t = ctx.cfg["talker_config"]

    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        mix, ctx = self.mix, self.ctx
        # The weights live in the model alone: the reference draws them
        # again from the seed once the window is over.
        self.model = sut.model(ctx.tts, sut.cell_weights(ctx), mix["int8"])
        # Host spans around the calls into the program, for the traced run.
        self.spans = tracing.Spans()
        for name in ("generate_codes_from_prompts", "decode_codes"):
            setattr(self.model, name, self.spans.wrap(name, getattr(self.model, name)))
        self._prompts = self.spans.wrap("build_prompt x rows", self._prompts)
        # Warm-up at the window's shapes: both sampling configurations'
        # frame programs (every row held to one frame), and the codec at
        # the calls' row lengths (the same each call: one block of the mix).
        rows = traffic.calls(mix, self.cfg, ctx.seed, 10 ** 6)["rows"]
        for greedy in (True, False):
            prompts = self._prompts(rows)
            self.model.generate_codes_from_prompts(
                prompts, self._params(greedy, 0), step_limit=[1] * len(rows),
                max_new_ceiling=mix["ceiling"], trailing_bucket=mix["trailing_bucket"])
        g = self.t["num_code_groups"]
        self.model.decode_codes([np.zeros((r["frames"], g), np.int32) for r in rows],
                                bucket=mix["codec_bucket"])
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def _prompts(self, rows):
        from qwen_tts_tpu_torch import graphs
        from qwen_tts_tpu_torch.generate import build_prompt

        m = self.model
        with graphs.device_lock:
            return [build_prompt(m.talker_params, m.cfg, np.asarray(r["text_ids"], np.int64),
                                 language=r["language"], speaker=r["speaker"]) for r in rows]

    def _params(self, greedy: bool, seed: int):
        from qwen_tts_tpu_torch.generate import GenerationParams

        mix = self.mix
        return GenerationParams(
            max_new_tokens=mix["ceiling"], do_sample=not greedy, top_k=mix["top_k"], top_p=1.0,
            temperature=mix["temperature"], repetition_penalty=mix["repetition_penalty"],
            min_new_tokens=mix["ceiling"] + 1, subtalker_do_sample=not greedy,
            subtalker_top_k=mix["top_k"], subtalker_top_p=1.0,
            subtalker_temperature=mix["temperature"], seed=seed)

    def per_frame_launches(self) -> int:
        return roofline.batch_frame_attention_launches(self.t)

    # -- the window --------------------------------------------------------

    def call(self, index: int, profile=None) -> dict:
        """One whole call; ``profile`` (a callable taking the call's start
        record) opens a sub-window inside it."""
        mix = self.mix
        spec = traffic.calls(mix, self.cfg, self.ctx.seed, index)
        rows = spec["rows"]
        seed = int(traffic.rng(self.ctx.seed, 4, index).integers(0, 2 ** 31 - 1))
        keep = self._check_rows(rows, spec["greedy"])
        t_a = time.perf_counter()
        prompts = self._prompts(rows)
        t_b = time.perf_counter()
        att0 = tracing.counters()["decode_attention"]
        sub = profile(t_b, att0) if profile is not None else None
        codes, _ = self.model.generate_codes_from_prompts(
            prompts, self._params(spec["greedy"], seed),
            step_limit=[r["frames"] + 1 for r in rows], max_new_ceiling=mix["ceiling"],
            trailing_bucket=mix["trailing_bucket"])
        t_c = time.perf_counter()
        steps = (tracing.counters()["decode_attention"] - att0) // self.per_frame_launches()
        wavs = self.model.decode_codes(codes, bucket=mix["codec_bucket"])
        t_d = time.perf_counter()
        red = sub() if sub is not None else None
        return {"index": index, "greedy": spec["greedy"], "rows": rows, "t": (t_a, t_b, t_c, t_d),
                "steps": steps, "frames": [int(c.shape[0]) for c in codes],
                "audio_s": sum(w.shape[0] for w in wavs) / self.ctx.tts.codec.output_sample_rate,
                "keep": {i: (codes[i], wavs[i]) for i in keep}, "trace": red}

    def _check_rows(self, rows, greedy: bool) -> List[int]:
        """The rows of a call the check may read: every row of a greedy
        call; of a sampled one, a seeded draw from each half of the batch."""
        if greedy:
            return list(range(len(rows)))
        half, n = len(rows) // 2, self.mix["check_sampled_per_half"]
        gen = traffic.rng(self.ctx.seed, 3)
        return [side[j] for side in (range(half), range(half, len(rows)))
                for j in gen.permutation(len(side))[:n]]

    def run(self, seconds: float, trace: bool) -> dict:
        calls = []
        t0 = time.perf_counter()
        tracer = _Tracer(self) if trace else None
        while time.perf_counter() - t0 < seconds:
            index = len(calls)
            profile = tracer.profile_for(calls) if tracer is not None else None
            calls.append(self.call(index, profile))
            if tracer is not None:
                tracer.took(calls[-1])
        return {"calls": calls, "trace": tracer.result() if tracer is not None else None}

    # -- readings ----------------------------------------------------------

    def metrics(self, rec: dict) -> dict:
        calls = rec["calls"]
        wall = calls[-1]["t"][3] - calls[0]["t"][0]
        audio = sum(c["audio_s"] for c in calls)
        walls = [c["t"][3] - c["t"][0] for c in calls]
        print(f"batch: {len(calls)} calls of {len(calls[0]['rows'])} rows "
              f"({sum(c['greedy'] for c in calls)} greedy), {audio:.2f} s of audio in "
              f"{wall:.3f} s; call wall median {statistics.median(walls):.3f} s "
              f"(min {min(walls):.3f}, max {max(walls):.3f}); decode steps a call "
              f"{[c['steps'] for c in calls]}", file=sys.stderr)
        return {"audio_s_per_s": (audio / wall, "s/s")}

    def attempted_failed(self, rec: dict):
        return len(rec["calls"]), 0

    def layer(self, rec: dict) -> dict:
        calls = rec["calls"]
        plen = sut.prompt_len(self.cfg)
        flops = sum(roofline.frames_flops(self.t, plen, f) for c in calls for f in c["frames"])
        return {"kind": "batch", "cfg": self.cfg, "mix": self.mix,
                "frame_s": sum(c["t"][2] - c["t"][1] for c in calls),
                "steps": sum(c["steps"] for c in calls),
                "codec_s": [c["t"][3] - c["t"][2] for c in calls],
                "calls_s": sum(c["t"][3] - c["t"][0] for c in calls),
                "flops": flops, "trace": rec["trace"]}

    def served_sample(self, rec: dict) -> List[dict]:
        """The check's rows of the window's first greedy call and of its
        first sampled call."""
        out = []
        for greedy in (True, False):
            c = next((c for c in rec["calls"] if c["greedy"] == greedy), None)
            if c is None:
                continue
            t_max = max(c["frames"])
            t_max = -(-t_max // self.mix["codec_bucket"]) * self.mix["codec_bucket"]
            half = len(c["rows"]) // 2
            for i, (codes, wav) in c["keep"].items():
                r = c["rows"][i]
                out.append({"text_ids": r["text_ids"], "speaker": r["speaker"],
                            "language": r["language"], "codes": codes, "greedy": greedy,
                            "top_k": self.mix["top_k"], "temperature": self.mix["temperature"],
                            "subtalker_top_k": self.mix["top_k"],
                            "subtalker_temperature": self.mix["temperature"],
                            "half": int(i >= half),
                            "repetition_penalty": self.mix["repetition_penalty"],
                            "min_new_tokens": self.mix["ceiling"] + 1, "audio": wav,
                            "codec": {"mode": "chunked", "t_max": t_max,
                                      "chunk": 300, "context": 25}})
        return out

    def missing_greedy(self, rec: dict) -> int:
        return 0 if any(c["greedy"] for c in rec["calls"]) else 1

    def release(self) -> None:
        sut.release(self.model)
        del self.model


class _Tracer:
    """The traced run's sub-windows: each opens during a call's frame loop,
    about ``trace_s`` seconds before the loop's end as the previous call's
    loop took, and closes once that call's codec is done, so it holds the
    deepest frames of the call, the loop's end and the codec. A sub-window
    whose replays or codec launches lost kernels is taken again on the
    next call, at most three times."""

    def __init__(self, driver: Driver):
        self.d = driver
        self.good: Optional[dict] = None
        self.last: Optional[dict] = None
        self.notes: List[str] = []
        self.tries = 0

    def profile_for(self, calls: list):
        if self.good is not None or not calls or self.tries >= 3:
            return None
        self.tries += 1
        loop_s = calls[-1]["t"][2] - calls[-1]["t"][1]
        offset = max(0.0, loop_s - float(self.d.mix["trace_s"]))
        per = self.d.per_frame_launches()
        spans = self.d.spans

        def open_at(t_b: float, att0: int):
            # The profiler starts and stops in one thread: this one opens the
            # sub-window at its time and closes it when the call says so.
            state = {}
            done = threading.Event()

            def tracer():
                wait = t_b + offset - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                prof = tracing.Profile(spans)
                state["before"] = prof.start()
                done.wait()
                _sync()
                state["after"] = tracing.counters()
                prof.stop()
                state["red"] = prof.reduce()

            thread = threading.Thread(target=tracer, daemon=True)
            thread.start()

            def close():
                done.set()
                thread.join()
                return {"red": state["red"], "before": state["before"], "after": state["after"],
                        "first_frame": (state["before"]["decode_attention"] - att0) // per}
            return close
        return open_at

    def took(self, call: dict) -> None:
        sub = call.get("trace")
        if sub is None:
            return
        red = sub["red"]
        launched = tracing.delta(sub["before"], sub["after"])
        per = self.d.per_frame_launches()
        replays = red.graph_replays()
        short = [len(r) for r in replays
                 if sum(1 for k in r if tracing.KERNELS["decode_attention"] in k[2]) != per]
        missing = tracing.complete(red, launched, ("vocoder_block",))
        if not replays:
            missing = (missing + "; " if missing else "") + "no graph replay in the sub-window"
        if short:
            missing = (missing + "; " if missing else "") + f"{len(short)} replays lost kernels"
        if missing is None:
            self.good = dict(sub, call=call, replays=replays)
            return
        self.notes.append(missing)
        self.last = sub
        print(f"trace: sub-window of call {call['index']} incomplete ({missing})",
              file=sys.stderr)

    def result(self) -> Optional[dict]:
        """The complete sub-window; else the last one taken, marked
        incomplete (its busy time stands, its kernel readings do not)."""
        if self.good is None:
            return dict(self.last or {}, incomplete=True, notes=self.notes)
        return dict(self.good, notes=self.notes)
