"""The benchmark's weights, made from the seed by the benchmark itself.

The tree's keys and shapes are the layout the port loads (the talker's, the
sub-talker's and the codec's dicts of tensors; a test holds them against the
port's own initialisers at a tiny size), worked out here from the
configuration file alone. The values are the benchmark's: matrices, tables
and convolutions N(0, 1/fan_in) times the configuration's ``init_gains``;
norms, LayerNorm scales and SnakeBeta's alpha and beta ones; biases zeros;
LayerScale at the configuration's initial scale; ConvNeXt's gamma 1e-6.

Each part (talker, sub-talker, codec) is drawn on the device in one call, on
a generator of its own seeded from the seed and the part, in the dtype it is
served in, then cut into its leaves. The program and the reference are
handed the same tensors: the reference draws them again after the window.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

PARTS = ("talker", "subtalker", "codec")

# A leaf: (path in its part's tree, shape, fan_in for a N(0, 1/fan_in)
# draw or None, the constant of a leaf that is not drawn).
Leaf = Tuple[tuple, tuple, Optional[int], float]


def _trunk(prefix: tuple, layers: int, hidden: int, heads: int, kv_heads: int,
           head_dim: int, inter: int, qk_norm: bool) -> List[Leaf]:
    q, kv = heads * head_dim, kv_heads * head_dim
    out = [(prefix + ("wq",), (layers, hidden, q), hidden, 0.0),
           (prefix + ("wk",), (layers, hidden, kv), hidden, 0.0),
           (prefix + ("wv",), (layers, hidden, kv), hidden, 0.0),
           (prefix + ("wo",), (layers, q, hidden), q, 0.0),
           (prefix + ("gate",), (layers, hidden, inter), hidden, 0.0),
           (prefix + ("up",), (layers, hidden, inter), hidden, 0.0),
           (prefix + ("down",), (layers, inter, hidden), inter, 0.0),
           (prefix + ("input_norm",), (layers, hidden), None, 1.0),
           (prefix + ("post_attn_norm",), (layers, hidden), None, 1.0)]
    if qk_norm:
        out += [(prefix + ("q_norm",), (layers, head_dim), None, 1.0),
                (prefix + ("k_norm",), (layers, head_dim), None, 1.0)]
    return out


def talker_leaves(cfg: dict) -> List[Leaf]:
    t = cfg["talker_config"]
    d, td, v = t["hidden_size"], t["text_hidden_size"], t["vocab_size"]
    return [(("codec_embedding",), (v, d), d, 0.0),
            (("text_embedding",), (t["text_vocab_size"], td), td, 0.0),
            (("text_proj_fc1",), (td, td), td, 0.0),
            (("text_proj_fc1_b",), (td,), None, 0.0),
            (("text_proj_fc2",), (td, d), td, 0.0),
            (("text_proj_fc2_b",), (d,), None, 0.0),
            *_trunk(("trunk",), t["num_hidden_layers"], d, t["num_attention_heads"],
                    t["num_key_value_heads"], t["head_dim"], t["intermediate_size"], True),
            (("norm",), (d,), None, 1.0),
            (("codec_head",), (d, v), d, 0.0)]


def subtalker_leaves(cfg: dict) -> List[Leaf]:
    d = cfg["talker_config"]["hidden_size"]
    c = cfg["talker_config"]["code_predictor_config"]
    g1, h, v = c["num_code_groups"] - 1, c["hidden_size"], c["vocab_size"]
    out = [(("embeds",), (g1, v, d), d, 0.0),
           *_trunk(("trunk",), c["num_hidden_layers"], h, c["num_attention_heads"],
                   c["num_key_value_heads"], c["head_dim"], c["intermediate_size"], True),
           (("norm",), (h,), None, 1.0),
           (("lm_heads",), (g1, h, v), h, 0.0)]
    if h != d:
        out += [(("input_proj",), (d, h), d, 0.0), (("input_proj_b",), (h,), None, 0.0)]
    return out


def codec_leaves(cfg: dict) -> List[Leaf]:
    dc = cfg["speech_tokenizer"]["decoder_config"]
    lat, dec, hid = dc["latent_dim"], dc["decoder_dim"], dc["hidden_size"]
    cbd, layers = dc["codebook_dim"], dc["num_hidden_layers"]
    out: List[Leaf] = [
        (("codebooks",), (dc["num_quantizers"], dc["codebook_size"], cbd), cbd, 0.0),
        (("pre_conv_w",), (3, cbd, lat), 3 * cbd, 0.0),
        (("pre_conv_b",), (lat,), None, 0.0),
        (("transformer", "input_proj_w"), (lat, hid), lat, 0.0),
        (("transformer", "input_proj_b"), (hid,), None, 0.0),
        *_trunk(("transformer", "trunk"), layers, hid, dc["num_attention_heads"],
                dc["num_key_value_heads"], hid // dc["num_attention_heads"],
                dc["intermediate_size"], False),
        (("transformer", "trunk", "attn_scale"), (layers, hid), None,
         dc["layer_scale_initial_scale"]),
        (("transformer", "trunk", "mlp_scale"), (layers, hid), None,
         dc["layer_scale_initial_scale"]),
        (("transformer", "norm"), (hid,), None, 1.0),
        (("transformer", "output_proj_w"), (hid, lat), hid, 0.0),
        (("transformer", "output_proj_b"), (lat,), None, 0.0)]
    for i, factor in enumerate(dc["upsampling_ratios"]):
        p, c = ("upsample", i), ("upsample", i, "convnext")
        out += [(p + ("tconv_w",), (factor, lat, lat), lat * factor, 0.0),
                (p + ("tconv_b",), (lat,), None, 0.0),
                (c + ("dw_w",), (7, 1, lat), 7, 0.0), (c + ("dw_b",), (lat,), None, 0.0),
                (c + ("ln_w",), (lat,), None, 1.0), (c + ("ln_b",), (lat,), None, 0.0),
                (c + ("pw1_w",), (lat, 4 * lat), lat, 0.0),
                (c + ("pw1_b",), (4 * lat,), None, 0.0),
                (c + ("pw2_w",), (4 * lat, lat), 4 * lat, 0.0),
                (c + ("pw2_b",), (lat,), None, 0.0), (c + ("gamma",), (lat,), None, 1e-6)]
    out += [(("vocoder_pre_w",), (7, lat, dec), 7 * lat, 0.0),
            (("vocoder_pre_b",), (dec,), None, 0.0)]
    for i, rate in enumerate(dc["upsample_rates"]):
        c_in, c_out = dec // 2 ** i, dec // 2 ** (i + 1)
        b = ("blocks", i)
        out += [(b + ("alpha",), (c_in,), None, 1.0), (b + ("beta",), (c_in,), None, 1.0),
                (b + ("tconv_w",), (2 * rate, c_in, c_out), c_in * rate, 0.0),
                (b + ("tconv_b",), (c_out,), None, 0.0)]
        for j in range(3):
            u = b + ("resunits", j)
            out += [(u + ("alpha1",), (c_out,), None, 1.0), (u + ("beta1",), (c_out,), None, 1.0),
                    (u + ("conv1_w",), (7, c_out, c_out), 7 * c_out, 0.0),
                    (u + ("conv1_b",), (c_out,), None, 0.0),
                    (u + ("alpha2",), (c_out,), None, 1.0), (u + ("beta2",), (c_out,), None, 1.0),
                    (u + ("conv2_w",), (1, c_out, c_out), c_out, 0.0),
                    (u + ("conv2_b",), (c_out,), None, 0.0)]
    out_dim = dec // 2 ** len(dc["upsample_rates"])
    out += [(("final_alpha",), (out_dim,), None, 1.0), (("final_beta",), (out_dim,), None, 1.0),
            (("final_conv_w",), (7, out_dim, 1), 7 * out_dim, 0.0),
            (("final_conv_b",), (1,), None, 0.0)]
    return out


LEAVES = {"talker": talker_leaves, "subtalker": subtalker_leaves, "codec": codec_leaves}


def gain_of(part: str, path: tuple, gains: Dict[str, float]) -> float:
    """The configuration's gain of a leaf, named by its part and its path
    with the list indices left out (``codec.blocks.resunits.conv2_w``)."""
    return float(gains.get(".".join((part,) + tuple(k for k in path if isinstance(k, str))), 1.0))


def _put(tree, path: tuple, value) -> None:
    for k, nxt in zip(path[:-1], path[1:]):
        if isinstance(tree, list):
            while len(tree) <= k:
                tree.append([] if isinstance(nxt, int) else {})
            tree = tree[k]
        else:
            tree = tree.setdefault(k, [] if isinstance(nxt, int) else {})
    if isinstance(tree, list):
        while len(tree) <= path[-1]:
            tree.append(None)
    tree[path[-1]] = value


def part_seed(seed: int, part: str) -> int:
    seq = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), PARTS.index(part)])
    return int(seq.generate_state(1, np.uint64)[0] & np.uint64(2 ** 63 - 1))


def draw_part(cfg: dict, part: str, seed: int, device, dtype,
              gains: Optional[Dict[str, float]] = None) -> dict:
    """One part's tree: every drawn leaf cut from one N(0, 1) draw in
    ``dtype`` on ``device``, scaled by its gain over sqrt(fan_in)."""
    leaves = LEAVES[part](cfg)
    gains = gains or {}
    n = sum(math.prod(shape) for _, shape, fan_in, _ in leaves if fan_in is not None)
    gen = torch.Generator(device=device).manual_seed(part_seed(seed, part))
    flat = torch.empty((n,), dtype=dtype, device=device).normal_(generator=gen)
    tree: dict = {}
    at = 0
    for path, shape, fan_in, const in leaves:
        if fan_in is None:
            leaf = torch.full(shape, const, dtype=dtype, device=device)
        else:
            size = math.prod(shape)
            scale = gain_of(part, path, gains) / math.sqrt(fan_in)
            leaf = flat[at: at + size].view(shape) * scale
            at += size
        _put(tree, path, leaf)
    del flat
    return tree


def draw(cfg: dict, seed: int, device, talker_dtype, codec_dtype) -> dict:
    """The talker's, the sub-talker's and the codec's weights of a run,
    with the configuration's ``init_gains``."""
    gains = cfg.get("init_gains", {})
    return {part: draw_part(cfg, part, seed, device,
                            codec_dtype if part == "codec" else talker_dtype, gains)
            for part in PARTS}
