"""HTTP serving front end, stdlib only (PyTorch counterpart of
``qwen_tts_tpu/server.py``).

Endpoints:
  POST /tts      {"text": ... | "ids": [...], "speaker": ..., "language": ...,
                  "instruct": ..., "voice": <cloned-voice id>,
                  "non_streaming": ..., "max_new_tokens": ..., "seed": ...}
                 → audio/wav
  POST /clone_voice  {"audio": <base64 WAV | URL | server path> |
                      {"pcm": [...], "sample_rate": N},
                      "ref_text": ..., "x_vector_only": ...}
                     → {"voice": id}  (registers a cloned voice; or loads a
                     saved voice file via {"voice_file": <server path>})
  POST /stream   one utterance as HTTP/1.1 chunked raw PCM16 (same body as
                 /tts, "voice" included)
  GET  /healthz  → {"status": "ok", ...engine stats}
  GET  /voices   → supported speakers and languages, registered cloned voices

Run on the card:  python -m qwen_tts_tpu_torch.server -d MODEL_DIR [--port 8000]
                  [--batch 8] [--continuous] [--serving-int8 --kv-int8]

The request threads do card work only under ``graphs.device_lock`` (a prompt
built on the card, a voice cloned, the window engine's solo stream); the
engine's worker holds it for its own.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import queue
import sys
import threading
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from qwen_tts_tpu_torch import graphs
from qwen_tts_tpu_torch.audio import _is_probably_base64, _is_url
from qwen_tts_tpu_torch.continuous import _build_prompt


def _wav_bytes(samples: np.ndarray, rate: int) -> bytes:
    pcm = np.clip(np.asarray(samples, np.float32) * 32767.0, -32768, 32767).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def make_handler(engine, model, *, voices_dir=None, allow_local_audio=False):
    """``voices_dir`` and ``allow_local_audio`` set what the endpoints
    trust. By default /clone_voice takes only base64 (or a data URI) or
    inline PCM and rejects server paths and URLs: a path or URL would let any
    client probe local files or make the server fetch any URL. 'voice_file'
    loads stay inside ``voices_dir`` when it is set and are refused when it
    is not. ``allow_local_audio`` accepts paths and URLs again, for trusted
    localhost deployments."""
    voices: dict = {}  # cloned-voice id → voice_clone_prompt dict
    voices_lock = threading.Lock()
    voices_root = os.path.realpath(voices_dir) if voices_dir else None

    def _check_voice_file(path: str) -> str:
        if allow_local_audio:
            return path
        if voices_root is None:
            raise ValueError(
                "'voice_file' loading is disabled — start the server with "
                "--voices-dir DIR (or --allow-local-audio) to enable it")
        real = os.path.realpath(os.path.join(voices_root, path))
        if not (real == voices_root or real.startswith(voices_root + os.sep)):
            raise ValueError("'voice_file' must be inside the voices dir")
        return real

    def _check_audio(audio):
        if allow_local_audio or not isinstance(audio, str):
            return audio
        if _is_url(audio) or (not _is_probably_base64(audio) and os.path.exists(audio)):
            raise ValueError(
                "path/URL audio forms are rejected over HTTP — send base64, "
                "a data: URI, or {'pcm': [...], 'sample_rate': N} (or start "
                "the server with --allow-local-audio)")
        return audio

    class Handler(BaseHTTPRequestHandler):
        # Chunked transfer is HTTP/1.1; under the stdlib's default HTTP/1.0 a
        # client reading to EOF would see the chunk sizes in the PCM.
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", **engine.stats})
            elif self.path == "/voices":
                with voices_lock:
                    cloned = sorted(voices)
                self._json(200, {
                    "speakers": model.get_supported_speakers(),
                    "languages": model.get_supported_languages(),
                    "cloned_voices": cloned,
                })
            elif self.path in ("/", "/index.html"):
                page = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "web", "index.html")
                try:
                    with open(page, "rb") as f:
                        body = f.read()
                except OSError:
                    self._json(404, {"error": "web client not found"})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "not found"})

        def _read_body(self):
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}")

        def do_POST(self):
            try:
                req = self._read_body()
            except Exception:
                self._json(400, {"error": "invalid JSON"})
                return
            if self.path == "/tts":
                self._tts(req)
            elif self.path == "/stream":
                self._stream(req)
            elif self.path == "/clone_voice":
                self._clone_voice(req)
            else:
                self._json(404, {"error": "not found"})

        def _clone_voice(self, req):
            """Register a cloned voice for later /tts and /stream requests."""
            try:
                if "voice_file" in req:
                    prompt = model.load_voice_clone_prompt(_check_voice_file(req["voice_file"]))
                elif "audio" in req:
                    audio = _check_audio(req["audio"])
                    if isinstance(audio, dict):
                        audio = (np.asarray(audio["pcm"], np.float32), int(audio["sample_rate"]))
                    with graphs.device_lock:  # the encoders run on the card
                        prompt = model.create_voice_clone_prompt(
                            audio, ref_text=req.get("ref_text"), sample_rate=None,
                            x_vector_only_mode=bool(req.get("x_vector_only", False)))
                else:
                    self._json(400, {"error": "need 'audio' or 'voice_file'"})
                    return
            except Exception as exc:
                self._json(400, {"error": str(exc)})
                return
            with voices_lock:
                vid = f"voice-{len(voices) + 1}"
                voices[vid] = prompt
            self._json(200, {"voice": vid, "icl": bool(prompt["icl_mode"][0])})

        def _clone_kwargs(self, req):
            """The 'voice', 'instruct' and 'non_streaming' fields as
            submit_ids keywords (shared by /tts and /stream)."""
            kw = {}
            vid = req.get("voice")
            if vid is not None:
                with voices_lock:
                    prompt = voices.get(vid)
                if prompt is None:
                    raise KeyError(f"unknown voice {vid!r} (POST /clone_voice first)")
                se, ri, rc = model.clone_prompt_inputs(prompt)
                kw.update(speaker_embed=se, ref_ids=ri, ref_codes=rc)
            instruct = req.get("instruct")
            if instruct:
                kw["instruct_ids"] = model._tokenize(model.build_instruct_text(instruct))
            if req.get("non_streaming"):
                kw["non_streaming"] = True
            return kw

        def _submit_kwargs(self, req):
            return {k: req[k] for k in (
                "max_new_tokens", "seed", "top_k", "top_p", "temperature",
                "repetition_penalty", "do_sample", "subtalker_dosample",
                "subtalker_top_k", "subtalker_top_p", "subtalker_temperature") if k in req}

        def _ids(self, req):
            if "ids" in req:
                return np.asarray(req["ids"], np.int64)
            if "text" in req:
                return model._tokenize(model.build_assistant_text(req["text"]))
            return None

        def _tts(self, req):
            try:
                ids = self._ids(req)
                if ids is None:
                    self._json(400, {"error": "need 'text' or 'ids'"})
                    return
                # Client errors (unknown voice, speaker or language, bad
                # ids) are answered 400 before submission, as /stream does.
                clone_kw = self._clone_kwargs(req)
            except (KeyError, ValueError) as exc:
                self._json(400, {"error": str(exc)})
                return
            except Exception as exc:
                self._json(500, {"error": str(exc)})
                return
            try:
                fut = engine.submit_ids(ids, speaker=req.get("speaker"),
                                        language=req.get("language", "auto"),
                                        **clone_kw, **self._submit_kwargs(req))
                wav = fut.result(timeout=600)
            except ValueError as exc:
                self._json(400, {"error": str(exc)})
                return
            except Exception as exc:
                self._json(500, {"error": str(exc)})
                return
            body = _wav_bytes(wav, model.sample_rate)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _stream(self, req):
            """Chunked raw PCM16 of one utterance, chunk by chunk as it decodes."""
            try:
                params = model._merge_params(**self._submit_kwargs(req))
                ids = self._ids(req)
                if ids is None:
                    self._json(400, {"error": "need 'text' or 'ids'"})
                    return
                clone_kw = self._clone_kwargs(req)
                ref_codes = clone_kw.pop("ref_codes", None)
                prompt = _build_prompt(model, ids, language=req.get("language", "auto"),
                                       speaker=req.get("speaker"), ref_codes=ref_codes,
                                       **clone_kw)
            except Exception as exc:
                self._json(400, {"error": str(exc)})
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("X-Sample-Rate", str(model.sample_rate))
            self.end_headers()
            try:
                for wav in self._wav_chunks(prompt, params, ref_codes):
                    pcm = np.clip(wav * 32767.0, -32768, 32767).astype("<i2").tobytes()
                    if not pcm:
                        continue
                    self.wfile.write(f"{len(pcm):X}\r\n".encode())
                    self.wfile.write(pcm + b"\r\n")
                self.wfile.write(b"0\r\n\r\n")
            except BrokenPipeError:
                pass

        def _wav_chunks(self, prompt, params, ref_codes=None):
            """The audio chunks: from a continuous engine's slot when there
            is one (concurrent streams share its frame program; ICL reference
            codes are each chunk's codec left context), else the solo
            resumable stream, each of its steps under the device lock."""
            if not hasattr(engine, "submit_prompt"):
                chunks = model.stream_from_prompt(prompt, params, ref_codes=ref_codes)
                while True:
                    with graphs.device_lock:
                        item = next(chunks, None)
                    if item is None:
                        return
                    yield item[0]
            chunks: "queue.Queue" = queue.Queue()
            fut = engine.submit_prompt(prompt, params,
                                       stream_callback=lambda wav, done: chunks.put((wav, done)),
                                       ref_codes=ref_codes)
            try:
                while True:
                    try:
                        wav, done = chunks.get(timeout=5.0)
                    except queue.Empty:
                        # The slot failed without a final callback (its future
                        # holds the exception): end the stream.
                        if fut.done():
                            return
                        continue
                    if wav.size:
                        yield wav
                    if done:
                        return
            finally:
                # A client that disconnected (BrokenPipeError closes the
                # generator) frees its slot instead of decoding its budget.
                if not fut.done():
                    engine.cancel(fut)

    return Handler


def build_argparser() -> argparse.ArgumentParser:
    """The JAX package's server flags."""
    p = argparse.ArgumentParser(prog="qwen-tts-serve")
    p.add_argument("-d", dest="model_dir", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=30.0)
    p.add_argument("--max-tokens", type=int, default=512)
    p.add_argument("--continuous", action="store_true",
                   help="per-slot continuous batching (requests join live "
                        "decode slots) instead of window batching")
    p.add_argument("--segment-frames", type=int, default=25)
    p.add_argument("--prefill-bucket", default="64",
                   help="prefill bucket, or a comma list e.g. 64,256 (a prompt "
                        "pads to the smallest bucket it fits; the pool's cache "
                        "is sized by the largest)")
    p.add_argument("--voices-dir", default=None,
                   help="directory 'voice_file' loads are restricted to "
                        "(disabled when unset — see make_handler)")
    p.add_argument("--allow-local-audio", action="store_true",
                   help="accept server-path/URL audio and any voice_file path "
                        "over HTTP (trusted localhost deployments only)")
    p.add_argument("--serving-int8", action="store_true",
                   help="int8 serving mode: int8 talker and sub-talker weights "
                        "(throughput; greedy codes differ from the bf16 "
                        "parity default)")
    p.add_argument("--kv-int8", action="store_true",
                   help="int8 talker KV cache (capacity for long budgets and "
                        "large slot pools; serving numerics)")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    model = Qwen3TTSModel.from_pretrained(args.model_dir)  # on the card
    if args.serving_int8:
        model.quantize_for_serving(talker=True, kv=args.kv_int8)
    elif args.kv_int8:
        model.kv_int8 = True  # the cache alone, float weights
    if args.continuous:
        from qwen_tts_tpu_torch.continuous import ContinuousBatchingEngine

        buckets = tuple(int(b) for b in str(args.prefill_bucket).split(",") if b)
        engine = ContinuousBatchingEngine(
            model, num_slots=args.batch, segment_frames=args.segment_frames,
            max_new_tokens=args.max_tokens,
            prefill_bucket=buckets if len(buckets) > 1 else buckets[0],
        ).start()
    else:
        from qwen_tts_tpu_torch.serving import ServingEngine

        engine = ServingEngine(model, max_batch=args.batch, max_wait_ms=args.max_wait_ms,
                               max_new_tokens=args.max_tokens).start()
    server = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(engine, model, voices_dir=args.voices_dir,
                     allow_local_audio=args.allow_local_audio))
    print(f"qwen-tts-serve listening on {args.host}:{args.port}", file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        engine.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
