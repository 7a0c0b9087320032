"""The port's HTTP front end (``qwen_tts_tpu_torch/server.py``) over both
engines on the tiny clone fixture, f32, on the CPU (the scenarios of
tests/test_serving.py, test_server_stream.py and test_server_clone.py).

/tts answers a WAV of the request's frames; /stream is HTTP/1.1 chunked
PCM16 that ``http.client`` de-chunks, within a few PCM steps of the one-shot
decode of the JAX package's solo greedy codes (each chunk re-decodes its
left context); /clone_voice registers a voice from base64, inline PCM or a
voice file under the trust model's rules; the flags are the JAX server's.
Every server and engine stops in a ``finally``; every request has a time
limit."""

import argparse
import base64
import contextlib
import http.client
import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import wave
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from torch_port_fixtures import (  # noqa: F401
    SERVING_CEILING,
    clone_checkpoint,
    jax_solo_codes,
    one_torch_thread,
    serving_models,
)
from qwen_tts_tpu import server as j_server
from qwen_tts_tpu_torch import server
from qwen_tts_tpu_torch.continuous import ContinuousBatchingEngine
from qwen_tts_tpu_torch.serving import ServingEngine
from qwen_tts_tpu_torch.voice_prompt import save_voice_clone_prompt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDS_A = [1, 2, 3, 10, 11, 12, 4, 5, 1, 2, 3]
IDS_B = [1, 2, 3, 20, 21, 22, 23, 4, 5, 1, 2, 3]
GREEDY = dict(do_sample=False, subtalker_dosample=False, repetition_penalty=1.0)
PCM_STEPS = 16  # the chunks' re-decoded context, as tests/test_server_stream.py allows
WAIT = 120


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return serving_models(clone_checkpoint(tmp_path_factory))


@pytest.fixture(scope="module")
def ref_wav():
    return (0.1 * np.sin(np.linspace(0, 150, 4800))).astype(np.float32)


def _continuous(tm):
    return ContinuousBatchingEngine(tm, num_slots=2, segment_frames=2,
                                    max_new_tokens=SERVING_CEILING, prefill_bucket=(32, 128),
                                    trailing_cap=32)


@contextlib.contextmanager
def _serving(engine, model, **kw):
    """The handler on 127.0.0.1 at a free port, over ``engine`` (started
    here); yields the port."""
    engine.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler(engine, model, **kw))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
        thread.join(timeout=WAIT)


def _post(port, path, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=WAIT)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=WAIT) as r:
        return json.load(r)


def _stream(port, ids, frames):
    """POST /stream and read the body through http.client, which de-chunks
    only real HTTP/1.1 chunked transfer."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    try:
        conn.request("POST", "/stream", body=json.dumps(dict(
            ids=ids, speaker="aiden", language="english", max_new_tokens=frames + 1,
            min_new_tokens=frames + 2, **GREEDY)), headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200 and resp.headers.get("Transfer-Encoding") == "chunked"
        return np.frombuffer(resp.read(), dtype="<i2")
    finally:
        conn.close()


def _pcm(wav):
    return np.clip(wav * 32767.0, -32768, 32767).astype("<i2")


def _expected_pcm(models, ids, frames):
    jm, tm = models
    return _pcm(tm.decode_codes([jax_solo_codes(jm, ids, frames)])[0])


def _wav_b64(wav, sr):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(_pcm(wav).tobytes())
    return base64.b64encode(buf.getvalue()).decode()


def test_http_endpoints_over_the_window_engine(models):
    _, tm = models
    with _serving(ServingEngine(tm, max_batch=2, max_wait_ms=5, max_new_tokens=3), tm) as port:
        assert _get(port, "/healthz")["status"] == "ok"
        assert "aiden" in _get(port, "/voices")["speakers"]
        with _post(port, "/tts", dict(ids=IDS_A, speaker="aiden", language="english",
                                      max_new_tokens=3, do_sample=False)) as r:
            assert r.headers["Content-Type"] == "audio/wav"
            assert r.read()[:4] == b"RIFF"
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, "/tts", {"speaker": "aiden"})
        assert e.value.code == 400


def test_stream_chunked_parse_and_content(models):
    _, tm = models
    with _serving(_continuous(tm), tm) as port:
        pcm = _stream(port, IDS_A, 6)
    want = _expected_pcm(models, IDS_A, 6)
    assert pcm.shape == want.shape
    assert np.abs(pcm.astype(np.int32) - want.astype(np.int32)).max() <= PCM_STEPS


def test_stream_over_the_window_engine_runs_the_solo_stream(models):
    """Without a continuous engine /stream runs the resumable solo stream
    (its steps under the device lock), with the same audio."""
    _, tm = models
    with _serving(ServingEngine(tm, max_batch=2, max_wait_ms=5, max_new_tokens=8), tm) as port:
        pcm = _stream(port, IDS_A, 6)
    want = _expected_pcm(models, IDS_A, 6)
    assert pcm.shape == want.shape
    assert np.abs(pcm.astype(np.int32) - want.astype(np.int32)).max() <= PCM_STEPS


def test_concurrent_streams_share_slots(models):
    _, tm = models
    results, errors = {}, []
    engine = _continuous(tm)
    with _serving(engine, tm) as port:
        def client(name, ids):
            try:
                results[name] = _stream(port, ids, 6)
            except Exception as exc:  # reported below
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(n, ids))
                   for n, ids in (("a", IDS_A), ("b", IDS_B))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads) and not errors
        assert engine.stats["requests"] == 2
    for name, ids in (("a", IDS_A), ("b", IDS_B)):
        want = _expected_pcm(models, ids, 6)
        assert results[name].shape == want.shape
        assert np.abs(results[name].astype(np.int32) - want.astype(np.int32)).max() <= PCM_STEPS


def test_tts_over_the_continuous_engine(models):
    _, tm = models
    with _serving(_continuous(tm), tm) as port:
        with _post(port, "/tts", dict(ids=[1, 2, 3, 30, 31, 32, 4, 5, 1, 2, 3],
                                      speaker="serena", language="auto", max_new_tokens=5,
                                      min_new_tokens=6, **GREEDY)) as r:
            body = r.read()
    assert body[:4] == b"RIFF"
    assert len(body) == 44 + 4 * tm.cfg.codec.decode_upsample_rate * 2  # 4 frames of PCM16


@pytest.mark.parametrize("engine_kind", ["window", "continuous"])
def test_http_clone_voice_roundtrip(models, ref_wav, engine_kind):
    """/clone_voice (base64 WAV) → /voices → /tts with the voice: the WAV of
    the pipeline's clone; an unknown voice is a client error."""
    _, tm = models
    engine = (ServingEngine(tm, max_batch=2, max_wait_ms=5, max_new_tokens=SERVING_CEILING)
              if engine_kind == "window" else _continuous(tm))
    with _serving(engine, tm) as port:
        with _post(port, "/clone_voice", {"audio": _wav_b64(ref_wav, 24000),
                                          "ref_text": "ref"}) as r:
            out = json.load(r)
        assert out["icl"] is True
        assert out["voice"] in _get(port, "/voices")["cloned_voices"]
        with _post(port, "/tts", dict(text="hi", language="english", voice=out["voice"],
                                      max_new_tokens=4, min_new_tokens=5, **GREEDY)) as r:
            body = r.read()
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, "/tts", {"text": "hi", "voice": "voice-999"})
        assert e.value.code == 400
    with wave.open(io.BytesIO(body)) as w:
        assert w.getframerate() == tm.sample_rate
        got = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")
    # The pipeline's clone from the same 16-bit audio the server decoded.
    with wave.open(io.BytesIO(base64.b64decode(_wav_b64(ref_wav, 24000)))) as w:
        heard = np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float32) / 32768
    prompt = tm.create_voice_clone_prompt((heard, 24000), ref_text="ref", sample_rate=None)
    want, _ = tm.generate_voice_clone("hi", prompt, language="english", max_new_tokens=4,
                                      min_new_tokens=5, **GREEDY)
    assert got.shape == want[0].shape
    assert np.abs(got.astype(np.int32) - _pcm(want[0]).astype(np.int32)).max() <= 1


def test_clone_voice_from_inline_pcm_streams_only_new_audio(models, ref_wav):
    """An inline-PCM clone streamed from a continuous slot: the reference
    frames are the codec's context, their audio never sent."""
    _, tm = models
    with _serving(_continuous(tm), tm) as port:
        with _post(port, "/clone_voice", {"audio": {"pcm": ref_wav.tolist(),
                                                    "sample_rate": 24000},
                                          "ref_text": "ref"}) as r:
            vid = json.load(r)["voice"]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
        try:
            conn.request("POST", "/stream", body=json.dumps(dict(
                text="hi", language="english", voice=vid, max_new_tokens=4, min_new_tokens=5,
                **GREEDY)))
            pcm = np.frombuffer(conn.getresponse().read(), dtype="<i2")
        finally:
            conn.close()
    assert pcm.shape == (3 * tm.cfg.codec.decode_upsample_rate,)


def test_http_instruct_and_non_streaming_fields(models):
    _, tm = models
    with _serving(ServingEngine(tm, max_batch=2, max_wait_ms=5, max_new_tokens=3), tm) as port:
        with _post(port, "/tts", dict(text="hi", language="english", speaker="aiden",
                                      instruct="speak warmly", non_streaming=True,
                                      max_new_tokens=3, **GREEDY)) as r:
            body = r.read()
    with wave.open(io.BytesIO(body)) as w:
        assert w.getnframes() > 0


def test_http_trust_model_rejects_paths_and_urls(models, ref_wav, tmp_path):
    """By default no server path or URL as audio and no voice file outside
    --voices-dir; base64 and a voice file inside it work."""
    _, tm = models
    prompt = tm.create_voice_clone_prompt(ref_wav, ref_text="ref")
    vdir = tmp_path / "voices"
    vdir.mkdir()
    save_voice_clone_prompt(prompt, str(vdir / "ok.npz"))
    save_voice_clone_prompt(prompt, str(tmp_path / "outside.npz"))
    wav_path = tmp_path / "ref.wav"
    wav_path.write_bytes(base64.b64decode(_wav_b64(ref_wav, 24000)))
    engine = ServingEngine(tm, max_batch=2, max_wait_ms=5, max_new_tokens=3)
    with _serving(engine, tm, voices_dir=str(vdir)) as port:
        for body in ({"audio": str(wav_path)}, {"audio": "http://169.254.169.254/latest"},
                     {"voice_file": "../outside.npz"}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(port, "/clone_voice", body)
            assert e.value.code == 400, body
        with _post(port, "/clone_voice", {"voice_file": "ok.npz"}) as r:
            assert "voice" in json.load(r)
        with _post(port, "/clone_voice", {"audio": _wav_b64(ref_wav, 24000),
                                          "ref_text": "ref"}) as r:
            assert "voice" in json.load(r)


def test_http_voice_file_disabled_without_voices_dir(models):
    _, tm = models
    with _serving(ServingEngine(tm, max_batch=2, max_wait_ms=5, max_new_tokens=3), tm) as port:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, "/clone_voice", {"voice_file": "/etc/passwd"})
        assert e.value.code == 400


def test_flags_are_the_jax_server_flags(monkeypatch):
    class Parsed(Exception):
        pass

    def capture(parser, *args, **kwargs):
        raise Parsed(parser)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Parsed) as e:
        j_server.main([])

    def flags(parser):
        return sorted((tuple(a.option_strings), a.dest, a.default, a.type, a.required)
                      for a in parser._actions)

    assert flags(server.build_argparser()) == flags(e.value.args[0])
    assert server.build_argparser().prog == e.value.args[0].prog


def test_module_entry_point_parses_the_flags():
    out = subprocess.run([sys.executable, "-m", "qwen_tts_tpu_torch.server", "--help"], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                         timeout=WAIT)
    assert out.returncode == 0, out.stderr
    for flag in ("--continuous", "--serving-int8", "--kv-int8", "--prefill-bucket",
                 "--voices-dir", "--allow-local-audio"):
        assert flag in out.stdout
