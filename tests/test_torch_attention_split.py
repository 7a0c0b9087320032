"""The decode-attention kernel's split over cache positions, on the CPU.

The kernel (``qwen_tts_tpu_torch/csrc/decode_attention.cu``) gives each of
``n_split`` blocks an equal share of a row's valid range and each of a
block's warps an equal share of that; a warp runs an online softmax over its
share in chunks of positions, and the partials merge in (block, warp)
order. ``choose_split``, ``valid_range`` and ``split_share``
mirror the host's choice and the device's integer arithmetic; here they are
held to the kernel's contract, and the split-and-merge algorithm, written out
in plain torch, is held against the JAX function and the Pallas kernel (in
interpret mode) on the same numpy inputs, f32."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_tts_tpu.ops import attention as j_attn
from qwen_tts_tpu.ops.pallas.decode_attention import pallas_attention_decode_step
from qwen_tts_tpu_torch.ops.attention import quantize_kv
from qwen_tts_tpu_torch.ops.cuda.decode_attention import (
    MAX_SPLIT,
    MIN_SLOTS_PER_SPLIT,
    NO_WINDOW,
    WARPS_PER_BLOCK,
    CHUNK,
    choose_split,
    split_ok,
    split_share,
    valid_range,
)
from torch_port_fixtures import one_torch_thread  # noqa: F401

# f32 on both sides; differences are summation order only.
ATOL = 2e-5
S_MAX = 300
# (cur_len, valid_from): the whole cache, a ragged start, an empty row, five
# valid positions (fewer than 16 splits), one valid position, a row whose
# cur_len is past S_max.
ROWS = [(300, 0), (150, 7), (9, 9), (40, 35), (200, 199), (310, 12)]
H, KV, HD = 16, 2, 64


@pytest.mark.parametrize("window", [None, 1, 5, 37, 400])
@pytest.mark.parametrize("n_split", [1, 2, 3, 4, 8, 16, 64])
def test_split_shares_tile_the_valid_range(n_split, window):
    # The partition's arithmetic, for any count: the blocks' shares (the
    # kernel takes powers of two up to MAX_SPLIT) and the warps' shares of them.
    for cur_len, valid_from in ROWS + [(0, 0), (5, -3), (1, 0)]:
        lo, hi, empty = valid_range(cur_len, valid_from, S_MAX,
                                    NO_WINDOW if window is None else window)
        want = [j for j in range(S_MAX) if j < cur_len and j >= valid_from
                and (window is None or j >= cur_len - window)]
        assert empty == (not want)
        assert list(range(lo, hi)) == (want or list(range(S_MAX)))
        shares = [split_share(lo, hi, n_split, r) for r in range(n_split)]
        covered = [j for start, end in shares for j in range(start, end)]
        assert covered == list(range(lo, hi))  # in rank order: no gap, no overlap
        sizes = [end - start for start, end in shares]
        assert max(sizes) - min(sizes) <= 1
        assert all(end >= start for start, end in shares)
        warps = [split_share(start, end, WARPS_PER_BLOCK, w)
                 for start, end in shares for w in range(WARPS_PER_BLOCK)]
        assert [j for start, end in warps for j in range(start, end)] == covered


@pytest.mark.parametrize("s_max,pairs,want", [
    (97, 4 * 2, 4),     # the path's talker cache at B=4
    (41, 2 * 2, 2),     # the parity phases' talker cache at B=2
    (81, 1 * 2, 4),     # the B=1 stream's talker cache
    (16, 4 * 8, 1),     # the sub-talker's cache
    (17, 4 * 8, 1),
    (2080, 4 * 2, 16),  # long talker caches
    (2080, 32 * 2, 8),
    (2080, 1 * 2, 16),
    (15, 1, 1),
])
def test_choose_split(s_max, pairs, want):
    n = choose_split(s_max, pairs)
    assert n == want
    assert 1 <= n <= MAX_SPLIT and n & (n - 1) == 0 and split_ok(n)
    assert n == 1 or n * MIN_SLOTS_PER_SPLIT <= s_max


@pytest.mark.parametrize("n_split,ok", [(0, False), (1, True), (2, True), (3, False),
                                        (6, False), (8, True), (16, True), (32, False)])
def test_split_ok_takes_powers_of_two_up_to_the_largest_cluster(n_split, ok):
    assert split_ok(n_split) == ok


def split_merge(q, k, v, cur_len, valid_from, window, n_split):
    """The kernel's algorithm in plain torch, f32: per (row, KV head) the
    shares of n_split blocks, each cut into WARPS_PER_BLOCK warp shares; per
    warp share an online softmax in chunks of CHUNK positions, or of one
    position when the block's share is at most CHUNK (the int8 scales folded
    as the kernel folds them); then the warps' partials merged in warp order
    and the blocks' in rank order. Takes the n_split the kernel takes."""
    assert split_ok(n_split), n_split
    int8 = isinstance(k, dict)
    kr, vr = (k["i8"].float(), v["i8"].float()) if int8 else (k, v)
    b, h, hd = q.shape
    s_max, kv = kr.shape[1], kr.shape[2]
    g = h // kv
    out = torch.empty(b, h, hd)
    for row in range(b):
        lo, hi, empty = valid_range(int(cur_len[row]), int(valid_from[row]), s_max,
                                    NO_WINDOW if window is None else window)
        blocks = [split_share(lo, hi, n_split, r) for r in range(n_split)]
        for head in range(kv):
            qg = q[row, head * g:(head + 1) * g]
            block_parts = []
            for b_start, b_end in blocks:
                step = 1 if b_end - b_start <= CHUNK else CHUNK
                parts = []
                for start, end in (split_share(b_start, b_end, WARPS_PER_BLOCK, w)
                                   for w in range(WARPS_PER_BLOCK)):
                    m = torch.full((g,), -torch.inf)
                    l, acc = torch.zeros(g), torch.zeros(g, hd)
                    for t0 in range(start, end, step):
                        t1 = min(t0 + step, end)
                        s = (qg @ kr[row, t0:t1, head].T) * hd ** -0.5
                        if int8:
                            s = s * k["s"][row, t0:t1, head]
                        if empty:
                            s = torch.full_like(s, -1e9)
                        m_new = torch.maximum(m, s.max(dim=-1).values)
                        c = torch.exp(m - m_new)
                        p = torch.exp(s - m_new[:, None])
                        l = l * c + p.sum(dim=-1)
                        if int8:
                            p = p * v["s"][row, t0:t1, head]
                        acc = acc * c[:, None] + p @ vr[row, t0:t1, head]
                        m = m_new
                    parts.append((m, l, acc))
                block_parts.append(merge(parts))
            m_all, l_all, o = merge(block_parts)
            out[row, head * g:(head + 1) * g] = o / l_all[:, None]
    return out


def merge(parts):
    """Partials (m, l, acc) merged in their order; a part with m = -inf
    (an empty share) has weight 0, also when every part is empty."""
    m_all = torch.stack([m for m, _, _ in parts]).max(dim=0).values
    weights = [torch.where(m_all == -torch.inf, 0.0, torch.exp(m - m_all)) for m, _, _ in parts]
    l_all = sum(l * w for (_, l, _), w in zip(parts, weights))
    acc = sum(acc * w[:, None] for (_, _, acc), w in zip(parts, weights))
    return m_all, l_all, acc


@functools.lru_cache(maxsize=None)
def _case(int8: bool, window):
    """Inputs from a seed and the JAX references: attention_decode_step and
    the Pallas kernel in interpret mode (over the dequantized cache for int8,
    which the Pallas kernel does not take)."""
    r = np.random.default_rng(5)
    b = len(ROWS)
    q = r.standard_normal((b, H, HD)).astype(np.float32)
    k, v = (r.standard_normal((b, S_MAX, KV, HD)).astype(np.float32) * 3 for _ in range(2))
    cur_len = np.array([c for c, _ in ROWS], np.int32)
    valid_from = np.array([f for _, f in ROWS], np.int32)
    if int8:
        k, v = ({"i8": i8.numpy(), "s": s.numpy()}
                for i8, s in (quantize_kv(torch.from_numpy(x)) for x in (k, v)))
        j_k, j_v = ({n: jnp.asarray(a) for n, a in c.items()} for c in (k, v))
        flat_k, flat_v = (c["i8"].astype(np.float32) * c["s"][..., None] for c in (k, v))
    else:
        j_k, j_v = jnp.asarray(k), jnp.asarray(v)
        flat_k, flat_v = k, v
    want = j_attn.attention_decode_step(
        jnp.asarray(q), j_k, j_v, cur_len=jnp.asarray(cur_len),
        valid_from=jnp.asarray(valid_from), sliding_window=window)
    pallas = pallas_attention_decode_step(
        jnp.asarray(q), jnp.asarray(flat_k), jnp.asarray(flat_v),
        cur_len=jnp.asarray(cur_len), valid_from=jnp.asarray(valid_from),
        sliding_window=window, interpret=True)
    return q, k, v, cur_len, valid_from, np.asarray(want), np.asarray(pallas)


@pytest.mark.parametrize("n_split", [1, 2, 4, 16])
@pytest.mark.parametrize("window", [None, 37])
@pytest.mark.parametrize("int8", [False, True])
def test_split_merge_matches_jax_and_pallas(int8, window, n_split):
    q, k, v, cur_len, valid_from, want, pallas = _case(int8, window)
    to_t = (lambda c: {n: torch.from_numpy(a) for n, a in c.items()}) if int8 else torch.from_numpy
    got = split_merge(torch.from_numpy(q), to_t(k), to_t(v), cur_len, valid_from, window,
                      n_split).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
