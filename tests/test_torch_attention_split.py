"""The decode-attention kernel's split over cache positions, on the CPU.

The kernel (``qwen_tts_tpu_torch/csrc/decode_attention.cu``) cuts each row's
valid range into chunks of CHUNK positions counted from the row's first and
deals chunk j to warp slot j mod (n_split x WARPS_PER_BLOCK) of the row's
``n_split`` blocks (a row of at most one chunk: equal shares over block 0's
warps, one position at a time); a warp runs an online softmax over its
chunks in order, and the partials merge in (block, warp) order.
``choose_split``, ``valid_range`` and ``split_share`` mirror the host's
choice and the device's integer arithmetic; here they are held to the
kernel's contract, and the split-and-merge algorithm, written out in plain
torch, is held against the JAX function and the Pallas kernel (in interpret
mode) on the same numpy inputs, f32, and shown to give a row the same bits
whatever the batch, S_max or left padding around it."""

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
# valid positions (fewer than 8 splits), one valid position, a row whose
# cur_len is past S_max.
ROWS = [(300, 0), (150, 7), (9, 9), (40, 35), (200, 199), (310, 12)]
H, KV, HD = 16, 2, 64


@pytest.mark.parametrize("window", [None, 1, 5, 37, 400])
@pytest.mark.parametrize("n_split", [1, 2, 3, 4, 8, 16, 64])
def test_split_shares_tile_the_valid_range(n_split, window):
    # The partition's arithmetic, for any count (the kernel takes powers of
    # two up to MAX_SPLIT): every warp's pieces together cover the valid
    # range once, each warp walks its pieces in order, and the pieces follow
    # the row's length alone, counted from its first position.
    for cur_len, valid_from in ROWS + [(0, 0), (5, -3), (1, 0)]:
        lo, hi, empty = valid_range(cur_len, valid_from, S_MAX,
                                    NO_WINDOW if window is None else window)
        want = [j for j in range(S_MAX) if j < cur_len and j >= valid_from
                and (window is None or j >= cur_len - window)]
        assert empty == (not want)
        assert list(range(lo, hi)) == (want or list(range(S_MAX)))
        warps = [split_share(lo, hi, n_split, r, w)
                 for r in range(n_split) for w in range(WARPS_PER_BLOCK)]
        covered = sorted(j for pieces in warps for start, end in pieces
                         for j in range(start, end))
        assert covered == list(range(lo, hi))  # no gap, no overlap
        n = hi - lo
        for pieces in warps:
            assert all(lo <= start < end <= hi for start, end in pieces)
            assert [p[0] for p in pieces] == sorted(p[0] for p in pieces)
            if n > CHUNK:  # whole chunks from lo, the last one ragged
                assert all((start - lo) % CHUNK == 0 and end - start <= CHUNK
                           for start, end in pieces)
        assert warps == [[(start + lo, end + lo) for start, end in split_share(0, n, n_split, r, w)]
                         for r in range(n_split) for w in range(WARPS_PER_BLOCK)]
        if n <= CHUNK or n_split * WARPS_PER_BLOCK * CHUNK >= n:
            assert all(len(pieces) <= 1 for pieces in warps)


@pytest.mark.parametrize("s_max,want", [
    (97, 2),     # the path's talker cache (32-slot prompt bucket + 65)
    (41, 1),     # the parity phases' talker cache
    (81, 2),     # the B=1 stream's talker cache
    (16, 1),     # the sub-talker's cache
    (17, 1),
    (300, 8),
    (1056, 8),  # long talker caches
    (2080, 8),
    (15, 1),
])
def test_choose_split(s_max, want):
    n = choose_split(s_max)
    assert n == want
    assert 1 <= n <= MAX_SPLIT and n & (n - 1) == 0 and split_ok(n)
    # Every row of the cache: at most one chunk a warp, unless the split is
    # the largest the host picks, the deal every longer row gets.
    assert n == MAX_SPLIT or n * WARPS_PER_BLOCK * CHUNK >= s_max


@pytest.mark.parametrize("n_split,ok", [(0, False), (1, True), (2, True), (3, False),
                                        (6, False), (8, True), (16, False), (32, False)])
def test_split_ok_takes_powers_of_two_up_to_the_largest_cluster(n_split, ok):
    assert split_ok(n_split) == ok


def split_merge(q, k, v, cur_len, valid_from, window, n_split):
    """The kernel's algorithm in plain torch, f32: per (row, KV head) the
    pieces of each warp of n_split blocks (``split_share``); per warp an
    online softmax over its pieces in order, a chunk at a time, or one
    position at a time on a row of at most CHUNK positions (the int8 scales
    folded as the kernel folds them); then the warps' partials merged in warp
    order and the blocks' in rank order. Takes the n_split the kernel takes."""
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
        step = 1 if hi - lo <= CHUNK else CHUNK
        for head in range(kv):
            qg = q[row, head * g:(head + 1) * g]
            block_parts = []
            for r in range(n_split):
                parts = []
                for w in range(WARPS_PER_BLOCK):
                    m = torch.full((g,), -torch.inf)
                    l, acc = torch.zeros(g), torch.zeros(g, hd)
                    for start, end in split_share(lo, hi, n_split, r, w):
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


@pytest.mark.parametrize("n_split", [1, 2, 4, 8])
@pytest.mark.parametrize("window", [None, 37])
@pytest.mark.parametrize("int8", [False, True])
def test_split_merge_matches_jax_and_pallas(int8, window, n_split):
    q, k, v, cur_len, valid_from, want, pallas = _case(int8, window)
    to_t = (lambda c: {n: torch.from_numpy(a) for n, a in c.items()}) if int8 else torch.from_numpy
    got = split_merge(torch.from_numpy(q), to_t(k), to_t(v), cur_len, valid_from, window,
                      n_split).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)


@pytest.mark.parametrize("int8", [False, True])
def test_split_merge_gives_a_row_the_same_bits_alone_and_in_a_batch(int8):
    """The algorithm's bits follow the row alone: a row of 37 and one of 150
    positions, alone in a cache of S_max 160 (n_split 4) and, shifted by left
    padding, in a batch of 4 with a cache of S_max 300 (n_split 8), and at
    the fewest splits whose warps cover both rows (4). Empty ranks merge as
    exact zeros."""
    r = np.random.default_rng(11)
    q = torch.from_numpy(r.standard_normal((4, H, HD)).astype(np.float32))
    k, v = (torch.from_numpy(r.standard_normal((4, 300, KV, HD)).astype(np.float32) * 3)
            for _ in range(2))
    if int8:
        k, v = ({"i8": i8, "s": s} for i8, s in (quantize_kv(x) for x in (k, v)))
    batch_rows = [(260, 223), (200, 50), (300, 0), (9, 9)]  # rows 0 and 1: 37, 150
    cl, vf = (torch.tensor(x, dtype=torch.int32) for x in zip(*batch_rows))
    both = split_merge(q, k, v, cl, vf, None, choose_split(300))
    covering = split_merge(q, k, v, cl, vf, None, 4)  # 16 warps, rows 0 and 1 <= 10 chunks
    assert torch.equal(both[:2], covering[:2])
    for row, shift in ((0, 223), (1, 50)):
        n = int(cl[row] - vf[row])

        def alone(x):
            # The row's valid positions moved to the front of a 160-slot cache.
            return x[row:row + 1, shift:shift + n].clone() if x.dim() > 2 else None

        def cut(c):
            if isinstance(c, dict):
                return {"i8": torch.zeros(1, 160, KV, HD, dtype=torch.int8).index_copy(
                            1, torch.arange(n), alone(c["i8"])),
                        "s": torch.zeros(1, 160, KV).index_copy(1, torch.arange(n),
                                                                  c["s"][row:row + 1,
                                                                         shift:shift + n])}
            return torch.zeros(1, 160, KV, HD).index_copy(1, torch.arange(n), alone(c))
        one = split_merge(q[row:row + 1], cut(k), cut(v), torch.tensor([n], dtype=torch.int32),
                          torch.tensor([0], dtype=torch.int32), None, choose_split(160))
        assert choose_split(160) != choose_split(300)
        assert torch.equal(one[0], both[row])
