"""``qwen-tts-demo`` — the Gradio UI of the PyTorch port (the counterpart of
``qwen_tts_tpu/demo.py``, which mirrors the reference demo,
qwen_tts/cli/demo.py): model-kind autodetection with per-kind tabs
(CustomVoice / VoiceDesign / Base voice clone incl. mic recording and a
Save/Load Voice tab), per-call status reporting, generation-parameter
controls seeded from CLI defaults, and SSL/share/concurrency server flags.
Every callback calls the port's ``Qwen3TTSModel``; ``main`` loads it on the
card. Gradio is an optional dependency; a clear error explains how to get
the UI when it's absent."""

from __future__ import annotations

import argparse
import sys
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def detect_model_kind(model) -> str:
    """Reference autodetect (demo.py:246-252): by tts_model_type."""
    kind = (model.cfg.tts_model_type or "").lower()
    if "custom" in kind:
        return "custom_voice"
    if "design" in kind:
        return "voice_design"
    if kind == "base":
        return "base"
    return "custom_voice"


def title_case_display(s: str) -> str:
    """Reference display names (demo.py:33-36): snake → Title Case."""
    return " ".join(w.capitalize() for w in str(s).split("_"))


def build_choices_and_map(
    items: Optional[List[str]],
) -> Tuple[List[str], Dict[str, str]]:
    """Display-name choices + reverse map (reference demo.py:39-44)."""
    items = items or []
    disp = [title_case_display(x) for x in items]
    return disp, {d: raw for d, raw in zip(disp, items)}


def normalize_gradio_audio(wav) -> np.ndarray:
    """Int-PCM/float → mono float32 in [-1, 1] (reference demo.py:192-221:
    full-range signed/unsigned int scaling, float peak-normalize only when
    above 1, clip, downmix)."""
    x = np.asarray(wav)
    if np.issubdtype(x.dtype, np.integer):
        info = np.iinfo(x.dtype)
        if info.min < 0:
            y = x.astype(np.float32) / max(abs(info.min), info.max)
        else:
            mid = (info.max + 1) / 2.0
            y = (x.astype(np.float32) - mid) / mid
    elif np.issubdtype(x.dtype, np.floating):
        y = x.astype(np.float32)
        m = float(np.max(np.abs(y))) if y.size else 0.0
        if m > 1.0 + 1e-6:
            y = y / (m + 1e-12)
    else:
        raise TypeError(f"Unsupported audio dtype: {x.dtype}")
    y = np.clip(y, -1.0, 1.0)
    if y.ndim > 1:
        y = y.mean(axis=-1).astype(np.float32)
    return y


def audio_to_pair(audio: Any) -> Optional[Tuple[np.ndarray, int]]:
    """Gradio audio value → (mono float32 @ original sr, sr), or None
    (reference demo.py:224-238 accepts (sr, wav) tuples and dicts)."""
    if audio is None:
        return None
    if (isinstance(audio, tuple) and len(audio) == 2
            and isinstance(audio[0], (int, np.integer))):
        sr, wav = audio
        return normalize_gradio_audio(wav), int(sr)
    if isinstance(audio, dict) and "sampling_rate" in audio and "data" in audio:
        return (normalize_gradio_audio(audio["data"]),
                int(audio["sampling_rate"]))
    return None


def _clone_prompt_from_ui(model, ref_audio, ref_text: str, xvec_only: bool):
    pair = audio_to_pair(ref_audio)
    if pair is None:
        raise ValueError("Reference audio is required.")
    if not xvec_only and not (ref_text or "").strip():
        raise ValueError(
            "Reference text is required unless 'x-vector only' is enabled."
        )
    wav, sr = pair
    return model.create_voice_clone_prompt(
        (wav, sr),
        ref_text=(ref_text.strip() if ref_text else None),
        sample_rate=None,
        x_vector_only_mode=bool(xvec_only),
    )


def build_demo(model, gen_defaults: Optional[Dict[str, Any]] = None):
    import gradio as gr

    kind = detect_model_kind(model)
    gd = dict(gen_defaults or {})
    lang_disp, lang_map = build_choices_and_map(
        model.get_supported_languages()
    )

    def gen_kwargs_inputs():
        """Sliders seeded from CLI defaults (reference demo.py:178-189)."""
        return [
            gr.Slider(1, 4096, value=gd.get("max_new_tokens", 2048), step=1,
                      label="max_new_tokens"),
            gr.Slider(0.0, 2.0, value=gd.get("temperature", 0.9), step=0.05,
                      label="temperature"),
            gr.Slider(0, 200, value=gd.get("top_k", 50), step=1,
                      label="top_k"),
            gr.Slider(0.0, 1.0, value=gd.get("top_p", 1.0), step=0.01,
                      label="top_p"),
            gr.Slider(1.0, 2.0, value=gd.get("repetition_penalty", 1.05),
                      step=0.01, label="repetition_penalty"),
        ]

    def unpack(mnt, temp, tk, tp, rp):
        kw = dict(max_new_tokens=int(mnt), temperature=temp, top_k=int(tk),
                  top_p=tp, repetition_penalty=rp)
        for k in ("subtalker_top_k", "subtalker_top_p",
                  "subtalker_temperature"):
            if gd.get(k) is not None:
                kw[k] = gd[k]
        return kw

    def lang_of(disp):
        return lang_map.get(disp, disp)

    with gr.Blocks(title="Qwen3-TTS (PyTorch)") as demo:
        gr.Markdown("# Qwen3-TTS — PyTorch/CUDA inference")
        if kind == "custom_voice":
            spk_disp, spk_map = build_choices_and_map(
                model.get_supported_speakers()
            )
            with gr.Tab("CustomVoice"):
                with gr.Row():
                    with gr.Column(scale=2):
                        text = gr.Textbox(label="Text", lines=3)
                        speaker = gr.Dropdown(spk_disp, label="Speaker")
                        language = gr.Dropdown(lang_disp, value="Auto",
                                               label="Language")
                        controls = gen_kwargs_inputs()
                        btn = gr.Button("Generate", variant="primary")
                    with gr.Column(scale=3):
                        audio = gr.Audio(label="Output", type="numpy")
                        status = gr.Textbox(label="Status", lines=2)

                def run_cv(text, speaker, language, *ctl):
                    try:
                        wavs, sr = model.generate_custom_voice(
                            text, spk_map.get(speaker, speaker),
                            lang_of(language), **unpack(*ctl)
                        )
                        return (sr, wavs[0]), "Finished."
                    except Exception as e:  # surfaced in the Status box
                        return None, f"{type(e).__name__}: {e}"

                btn.click(run_cv, [text, speaker, language, *controls],
                          [audio, status])
        elif kind == "voice_design":
            with gr.Tab("VoiceDesign"):
                with gr.Row():
                    with gr.Column(scale=2):
                        text = gr.Textbox(label="Text", lines=3)
                        instruct = gr.Textbox(label="Voice description",
                                              lines=2)
                        language = gr.Dropdown(lang_disp, value="Auto",
                                               label="Language")
                        controls = gen_kwargs_inputs()
                        btn = gr.Button("Generate", variant="primary")
                    with gr.Column(scale=3):
                        audio = gr.Audio(label="Output", type="numpy")
                        status = gr.Textbox(label="Status", lines=2)

                def run_vd(text, instruct, language, *ctl):
                    try:
                        wavs, sr = model.generate_voice_design(
                            text, instruct, lang_of(language), **unpack(*ctl)
                        )
                        return (sr, wavs[0]), "Finished."
                    except Exception as e:
                        return None, f"{type(e).__name__}: {e}"

                btn.click(run_vd, [text, instruct, language, *controls],
                          [audio, status])
        else:  # base: voice clone (file upload or mic) + save/load voices
            with gr.Tab("Clone & Generate"):
                with gr.Row():
                    with gr.Column(scale=2):
                        ref = gr.Audio(label="Reference audio", type="numpy",
                                       sources=["upload", "microphone"])
                        ref_text = gr.Textbox(label="Reference transcript",
                                              lines=2)
                        xvec_only = gr.Checkbox(
                            label="x-vector only (no ICL; lower quality)"
                        )
                    with gr.Column(scale=2):
                        text = gr.Textbox(label="Text to speak", lines=3)
                        language = gr.Dropdown(lang_disp, value="Auto",
                                               label="Language")
                        controls = gen_kwargs_inputs()
                        btn = gr.Button("Generate", variant="primary")
                    with gr.Column(scale=3):
                        audio = gr.Audio(label="Output", type="numpy")
                        status = gr.Textbox(label="Status", lines=2)

                def run_clone(ref, ref_text, xvec_only, text, language, *ctl):
                    try:
                        prompt = _clone_prompt_from_ui(
                            model, ref, ref_text, xvec_only
                        )
                        wavs, sr = model.generate_voice_clone(
                            text, prompt, lang_of(language), **unpack(*ctl)
                        )
                        return (sr, wavs[0]), "Finished."
                    except Exception as e:
                        return None, f"{type(e).__name__}: {e}"

                btn.click(
                    run_clone,
                    [ref, ref_text, xvec_only, text, language, *controls],
                    [audio, status],
                )
            # Reference demo.py:452-583: persist a cloned voice to a file
            # and synthesize later from the file alone (no reference audio).
            with gr.Tab("Save / Load Voice"):
                with gr.Row():
                    with gr.Column(scale=2):
                        gr.Markdown("Save a reusable voice file (.pt, "
                                    "reference-compatible).")
                        ref_s = gr.Audio(label="Reference audio",
                                         type="numpy",
                                         sources=["upload", "microphone"])
                        ref_text_s = gr.Textbox(
                            label="Reference transcript", lines=2
                        )
                        xvec_only_s = gr.Checkbox(label="x-vector only")
                        save_btn = gr.Button("Save voice file",
                                             variant="primary")
                        voice_file_out = gr.File(label="Voice file")
                        save_status = gr.Textbox(label="Status", lines=2)
                    with gr.Column(scale=2):
                        gr.Markdown("Generate from a saved voice file.")
                        voice_file_in = gr.File(label="Voice file")
                        text2 = gr.Textbox(label="Text to speak", lines=3)
                        language2 = gr.Dropdown(lang_disp, value="Auto",
                                                label="Language")
                        gen_btn2 = gr.Button("Generate", variant="primary")
                    with gr.Column(scale=3):
                        audio2 = gr.Audio(label="Output", type="numpy")
                        status2 = gr.Textbox(label="Status", lines=2)

                def save_voice(ref, ref_text, xvec_only):
                    try:
                        prompt = _clone_prompt_from_ui(
                            model, ref, ref_text, xvec_only
                        )
                        fd_path = tempfile.mkstemp(
                            prefix="voice_clone_prompt_", suffix=".pt"
                        )
                        import os

                        os.close(fd_path[0])
                        model.save_voice_clone_prompt(prompt, fd_path[1])
                        return fd_path[1], "Finished."
                    except Exception as e:
                        return None, f"{type(e).__name__}: {e}"

                def load_voice_and_gen(file_obj, text, language):
                    try:
                        if file_obj is None:
                            raise ValueError("Voice file is required.")
                        if not (text or "").strip():
                            raise ValueError("Target text is required.")
                        path = (getattr(file_obj, "name", None)
                                or getattr(file_obj, "path", None)
                                or str(file_obj))
                        prompt = model.load_voice_clone_prompt(path)
                        wavs, sr = model.generate_voice_clone(
                            text, prompt, lang_of(language)
                        )
                        return (sr, wavs[0]), "Finished."
                    except Exception as e:
                        return None, f"{type(e).__name__}: {e}"

                save_btn.click(save_voice, [ref_s, ref_text_s, xvec_only_s],
                               [voice_file_out, save_status])
                gen_btn2.click(load_voice_and_gen,
                               [voice_file_in, text2, language2],
                               [audio2, status2])
    return demo


def build_parser() -> argparse.ArgumentParser:
    """CLI surface mirroring the reference (cli/demo.py:62-168): positional
    checkpoint or -c/-d, server/SSL flags, generation-default flags."""
    p = argparse.ArgumentParser(prog="qwen-tts-demo")
    p.add_argument("checkpoint_pos", nargs="?", default=None,
                   help="model checkpoint dir (positional)")
    p.add_argument("-c", "--checkpoint", "-d", "--model-dir",
                   dest="checkpoint", default=None)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "bf16", "float32", "fp32"],
                   help="talker compute dtype (fp32 = parity mode)")
    p.add_argument("--ip", "--host", dest="host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--share", action="store_true")
    p.add_argument("--ssl-certfile", default=None)
    p.add_argument("--ssl-keyfile", default=None)
    p.add_argument("--no-ssl-verify", action="store_true")
    p.add_argument("--concurrency", type=int, default=1,
                   help="max concurrent generation requests")
    # Generation defaults seeded into the UI (reference demo.py:160-167).
    p.add_argument("--max-new-tokens", type=int, default=None)
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--repetition-penalty", type=float, default=None)
    p.add_argument("--subtalker-top-k", type=int, default=None)
    p.add_argument("--subtalker-top-p", type=float, default=None)
    p.add_argument("--subtalker-temperature", type=float, default=None)
    return p


def collect_gen_defaults(args: argparse.Namespace) -> Dict[str, Any]:
    """Reference demo.py:178-189: only explicitly-set flags override."""
    mapping = {
        "max_new_tokens": args.max_new_tokens,
        "temperature": args.temperature,
        "top_k": args.top_k,
        "top_p": args.top_p,
        "repetition_penalty": args.repetition_penalty,
        "subtalker_top_k": args.subtalker_top_k,
        "subtalker_top_p": args.subtalker_top_p,
        "subtalker_temperature": args.subtalker_temperature,
    }
    return {k: v for k, v in mapping.items() if v is not None}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    ckpt = args.checkpoint or args.checkpoint_pos
    if not ckpt:
        build_parser().print_help()
        return 2

    try:
        import gradio  # noqa: F401
    except ImportError:
        print(
            "gradio is not installed in this environment. Install it "
            "(pip install gradio) to use the web demo, or use the CLI "
            "(python -m qwen_tts_tpu_torch.cli) / HTTP server "
            "(python -m qwen_tts_tpu_torch.server) instead.",
            file=sys.stderr,
        )
        return 3

    import torch

    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    talker_dtype = (torch.float32 if args.dtype in ("float32", "fp32")
                    else torch.bfloat16)
    # On the card (from_pretrained's default; it raises without one).
    model = Qwen3TTSModel.from_pretrained(ckpt, talker_dtype=talker_dtype)
    demo = build_demo(model, collect_gen_defaults(args))
    demo.queue(default_concurrency_limit=args.concurrency)
    demo.launch(
        server_name=args.host, server_port=args.port, share=args.share,
        ssl_certfile=args.ssl_certfile, ssl_keyfile=args.ssl_keyfile,
        ssl_verify=not args.no_ssl_verify,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
