"""The port's rANS coder (plain PyTorch versions of Kernels 2 and 3)
against the JAX package: its numpy golden model and its jitted lane scans.
Integer-only, so everything must be exact: symbols, states, offsets and
stream bytes."""
import torch_helpers  # noqa: F401  (first: caps torch's threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llicti_tpu.coder import rans_device as jr
from llicti_torch.coder import rans as tr


def make_cum(rng, n, Lp, floor0=False):
    """Random [n, Lp] int32 tables obeying the coder contract; with
    ``floor0`` the first entry is > 0, as the CDF kernel can leave it."""
    alphas = np.full(Lp - 1, 0.05)
    alphas[rng.integers(0, Lp - 1, size=2)] = 8.0
    p = rng.dirichlet(alphas, size=n)
    cdf = np.concatenate([np.zeros((n, 1)), np.cumsum(p, -1)], -1)
    if floor0:
        cdf[:, 0] = rng.uniform(0.0, 0.01, n)
    cdf = np.clip(cdf, 0, 1).astype(np.float32)
    return np.array(jr.cdf_float_to_cum_int32(jnp.asarray(cdf)))


def sample_syms(rng, cum):
    """Symbols in [0, Lp-2] drawn through the table."""
    u = rng.integers(int(cum[:, 0].max()), 2 ** 16, size=cum.shape[0])
    s = np.sum(cum[:, :-1] <= u[:, None], axis=-1) - 1
    return np.clip(s, 0, cum.shape[1] - 2).astype(np.int32)


def start_freq(cum, syms):
    i = np.arange(len(syms))
    starts = cum[i, syms]
    return starts.astype(np.int32), (cum[i, syms + 1] - starts).astype(
        np.int32)


def port_encode(slices, N):
    """Encode slices (decode order) with the port; -> (blob, per-slice
    cursors in encode order)."""
    states = torch.full((N,), tr.RANS_L, dtype=torch.int64)
    cursor = torch.zeros((1,), dtype=torch.int32)
    cap = sum(len(s) for _, s in slices) + N
    buf = torch.zeros((cap,), dtype=torch.int32)
    cursors = []
    for cum, syms in reversed(slices):
        st, fr = start_freq(cum, syms)
        tr.rans_encode(torch.from_numpy(st), torch.from_numpy(fr), states,
                       cursor, buf)
        cursors.append(int(cursor[0]))
    total = int(cursor[0])
    return tr.pack_stream_packed(buf[:total].numpy(), states.numpy()), cursors


def port_decode(blob, slices, N):
    st, words = tr.unpack_stream(blob, N)
    states = torch.from_numpy(st.astype(np.int64))
    offset = torch.zeros((1,), dtype=torch.int32)
    words_t = torch.from_numpy(words)
    out = [tr.rans_decode(torch.from_numpy(cum), words_t, states,
                          offset).numpy() for cum, _ in slices]
    return out, states, int(offset[0]), len(words)


@pytest.mark.parametrize("N,n,Lp", [(8, 1000, 257), (16, 230, 64),
                                    (4, 17, 513), (32, 999, 129)])
def test_single_slice_matches_golden_model(N, n, Lp):
    rng = np.random.default_rng(N + n)
    cum = make_cum(rng, n, Lp)
    syms = sample_syms(rng, cum)
    ref = jr.RansRefEncoder(N)
    ref.encode_slice(*start_freq(cum, syms))
    ref_words, ref_states = ref.finish()
    blob, _ = port_encode([(cum, syms)], N)
    assert blob == jr.pack_stream_packed(ref_words[::-1], ref_states)
    out, states, off, W = port_decode(blob, [(cum, syms)], N)
    np.testing.assert_array_equal(out[0], syms)
    ref_dec = jr.RansRefDecoder(ref_words, ref_states)
    np.testing.assert_array_equal(ref_dec.decode_slice(cum), syms)
    np.testing.assert_array_equal(states.numpy(),
                                  ref_dec.states.astype(np.int64))
    assert off == W == ref_dec.pos


@jax.jit
def _jax_chain(st_fr, states, buf):
    """The JAX package's encode chain: rans_encode_body_batch per slice."""
    cursor = jnp.zeros((1,), jnp.int32)
    for st, fr in st_fr:
        buf, cursor, states = jr.rans_encode_body_batch(
            st[None], fr[None], states, cursor, buf, states.shape[1])
    return buf, cursor, states


@pytest.mark.parametrize("N,floor0", [(16, False), (32, True)])
def test_chain_blob_matches_jax(N, floor0):
    """Blob byte-identical to JAX rans_encode_body_batch + pack_stream_packed
    over a chain of slices whose sizes are not multiples of N; the port
    decodes the JAX blob to the same symbols, states and offset as JAX."""
    rng = np.random.default_rng(N)
    slices = []
    for n, Lp in [(513, 257), (222, 513), (64, 33), (1000, 257)]:
        cum = make_cum(rng, n, Lp, floor0)
        slices.append((cum, sample_syms(rng, cum)))
    blob, cursors = port_encode(slices, N)

    st_fr = tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in
                  (start_freq(c, s) for c, s in reversed(slices)))
    cap = sum(len(s) for _, s in slices) + N
    buf, cursor, states = _jax_chain(
        st_fr, jnp.full((1, N), jr.RANS_L, jnp.uint32),
        jnp.zeros((1, cap), jnp.int32))
    total = int(cursor[0])
    assert total == cursors[-1]
    jblob = jr.pack_stream_packed(np.asarray(buf)[0][:total],
                                  np.asarray(states)[0])
    assert blob == jblob

    out, st, off, W = port_decode(jblob, slices, N)
    jst, jwords = jr.unpack_stream(jblob, N)
    jst = jnp.asarray(jst, jnp.uint32)[None]
    joff = jnp.zeros((1,), jnp.int32)
    for (cum, syms), got in zip(slices, out):
        np.testing.assert_array_equal(got, syms)
        jsyms, jst, joff = jr.rans_decode_body_batch(
            jnp.asarray(cum)[None], jnp.asarray(jwords)[None], jst, joff, N,
            len(syms))
        np.testing.assert_array_equal(np.asarray(jsyms)[0], syms)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst)[0])
    assert off == int(joff[0]) == W


def chain_inputs(rng, sizes):
    """(start, freq) int32 arrays per slice, in encode order: ``sizes``
    holds (symbols, masked entries) per slice, the masked ones (freq 0,
    any start) after the symbols."""
    out = []
    for n, pad in sizes:
        st = fr = np.zeros(0, np.int32)
        if n:
            cum = make_cum(rng, n, int(rng.choice([2, 33, 257])), True)
            st, fr = start_freq(cum, sample_syms(rng, cum))
        out.append((np.concatenate([st, rng.integers(0, 2 ** 16, pad)
                                    .astype(np.int32)]),
                    np.concatenate([fr, np.zeros(pad, np.int32)])))
    return out


@pytest.mark.parametrize("N,sizes", [
    (16, ((0, 0), (5, 0), (40, 7), (16, 0), (0, 3), (123, 20))),
    (32, ((31, 1), (0, 0), (64, 0), (200, 33))),
    (1, ((3, 0), (0, 0), (7, 2)))])
def test_encode_chain_matches_jax_and_slice_loop(N, sizes):
    """rans_encode_chain (plain) against the JAX chain (rans_encode_group)
    and against one rans_encode call per slice: identical words, per-slice
    cursors and final states, from carried states that include 2^16 and
    2^32 - 1; with empty slices, slices shorter than N and masked
    padding."""
    rng = np.random.default_rng(100 + N)
    st_fr = chain_inputs(rng, sizes)
    x0 = rng.integers(2 ** 16, 2 ** 32, N, dtype=np.int64)
    x0[::2] = 2 ** 16
    x0[1::3] = 2 ** 32 - 1
    cap = sum(len(fr) for _, fr in st_fr) + N

    def carry():
        return (torch.from_numpy(x0.copy()), torch.full((1,), 3, dtype=
                torch.int32), torch.zeros((cap,), dtype=torch.int32))

    states, cursor, buf = carry()
    offsets = torch.from_numpy(np.cumsum([0] + [len(fr) for _, fr in st_fr]))
    cursors = tr.rans_encode_chain(
        torch.from_numpy(np.concatenate([st for st, _ in st_fr])),
        torch.from_numpy(np.concatenate([fr for _, fr in st_fr])), offsets,
        states, cursor, buf)
    assert cursors.dtype == torch.int32 and cursors.shape == (len(sizes),)

    ls, lc, lb = carry()
    loop = []
    for st, fr in st_fr:
        tr.rans_encode(torch.from_numpy(st), torch.from_numpy(fr), ls, lc, lb)
        loop.append(int(lc[0]))
    assert cursors.tolist() == loop and int(cursor[0]) == loop[-1]
    assert torch.equal(states, ls) and torch.equal(buf, lb)

    jbuf, jcur, jst, jcurs = jr.rans_encode_group(
        tuple(jnp.asarray(st) for st, _ in st_fr),
        tuple(jnp.asarray(fr) for _, fr in st_fr),
        jnp.asarray(x0.astype(np.uint32)), jnp.full((1,), 3, jnp.int32),
        jnp.zeros((cap,), jnp.int32), N)
    assert [int(np.asarray(c).reshape(-1)[0]) for c in jcurs] == loop
    np.testing.assert_array_equal(states.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))


def test_encode_chain_rejects_bad_offsets():
    starts = torch.zeros((10,), dtype=torch.int32)
    states = torch.full((4,), tr.RANS_L, dtype=torch.int64)
    cursor = torch.zeros((1,), dtype=torch.int32)
    buf = torch.zeros((16,), dtype=torch.int32)
    for offsets in ([0, 4, 9], [1, 10], [0, 6, 4, 10], [0], [0, 11]):
        with pytest.raises(ValueError):
            tr.rans_encode_chain(starts, starts, torch.tensor(offsets),
                                 states, cursor, buf)
    with pytest.raises(ValueError):
        tr.rans_encode_chain(starts, starts, torch.tensor([0, 10]).int(),
                             states, cursor, buf)
    with pytest.raises(ValueError):
        tr.rans_encode_chain(starts, starts, torch.tensor(
            list(range(tr.MAX_SLICES)) + [10] * 2), states, cursor, buf)
    assert tr.rans_encode_chain(starts, starts, torch.tensor([0, 0, 10]),
                                states, cursor, buf).tolist() == [0, 0]


def test_decode_masked_search_below_first_entry():
    """A slot below cum[0] gives s = -1 with (start, freq) = (0, cum[0]),
    as the JAX scan's masked reductions do; a stream that runs out of
    words reads zeros instead of leaving the buffer."""
    N = 4
    cum = np.tile(np.array([[5000, 20000, 40000, 65536]], np.int32), (8, 1))
    states = np.array([70000, 65536 + 100, 2 ** 31 + 3, 2 ** 32 - 1],
                      np.uint32)
    words = np.array([7, 9], np.int32)
    st_t = torch.from_numpy(states.astype(np.int64))
    off_t = torch.zeros((1,), dtype=torch.int32)
    got = tr.rans_decode(torch.from_numpy(cum), torch.from_numpy(words),
                         st_t, off_t)
    jsyms, jst, joff = jr.rans_decode_body_batch(
        jnp.asarray(cum)[None], jnp.asarray(words)[None],
        jnp.asarray(states)[None], jnp.zeros((1,), jnp.int32), N, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsyms)[0])
    assert (got.numpy() == -1).any()
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(jst)[0])
    assert int(off_t[0]) == int(joff[0])


def test_masked_symbols_cost_nothing():
    """freq 0 marks a no-op: padding a slice with such entries leaves the
    stream unchanged."""
    rng = np.random.default_rng(5)
    N = 8
    cum = make_cum(rng, 77, 65)
    st, fr = start_freq(cum, sample_syms(rng, cum))

    def enc(st, fr):
        states = torch.full((N,), tr.RANS_L, dtype=torch.int64)
        cursor = torch.zeros((1,), dtype=torch.int32)
        buf = torch.zeros((200,), dtype=torch.int32)
        tr.rans_encode(torch.from_numpy(st), torch.from_numpy(fr), states,
                       cursor, buf)
        return tr.pack_stream_packed(buf[:int(cursor[0])].numpy(),
                                     states.numpy())

    pad = np.zeros(51, np.int32)
    assert enc(st, fr) == enc(np.concatenate([st, pad + 3]),
                              np.concatenate([fr, pad]))


def test_wrappers_reject_bad_input():
    cum = torch.zeros((4, 9), dtype=torch.int32)
    words = torch.zeros((3,), dtype=torch.int32)
    states = torch.full((4,), tr.RANS_L, dtype=torch.int64)
    off = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError):
        tr.rans_decode(cum.long(), words, states, off)
    with pytest.raises(ValueError):
        tr.rans_decode(cum, words, states.int(), off)
    with pytest.raises(ValueError):  # no lane
        tr.rans_decode(cum, words, torch.zeros((0,), dtype=torch.int64),
                       off)
    with pytest.raises(ValueError):
        tr.rans_encode(words, words[:2], states, off, words)
    with pytest.raises(ValueError):
        tr.rans_encode(words, words, states, off.long(), words)
    with pytest.raises(ValueError):
        tr.unpack_stream(b"\0" * 7, 2)


@jax.jit
def _jax_chain_batch(st_fr, states, buf):
    """The JAX package's K-image encode chain (its codec's do_chain):
    rans_encode_body_batch per slice on [K, ...] carries."""
    cursor = jnp.zeros((states.shape[0],), jnp.int32)
    cursors = []
    for st, fr in st_fr:
        buf, cursor, states = jr.rans_encode_body_batch(
            st, fr, states, cursor, buf, states.shape[1])
        cursors.append(cursor)
    return buf, jnp.stack(cursors, axis=1), states


def batch_chain_inputs(rng, K, sizes):
    """K images' (start, freq) per slice in encode order, each slice as
    [K, n] arrays: the images share the slice sizes (one shape) and differ
    in their tables and symbols."""
    per_image = [chain_inputs(rng, sizes) for _ in range(K)]
    return [(np.stack([img[s][0] for img in per_image]),
             np.stack([img[s][1] for img in per_image]))
            for s in range(len(sizes))]


@pytest.mark.parametrize("N,K,sizes", [
    (16, 3, ((0, 0), (5, 0), (40, 7), (16, 0), (123, 20))),
    (32, 2, ((31, 1), (0, 0), (200, 33))),
    (8, 1, ((3, 0), (70, 2)))])
def test_batched_encode_chain_matches_jax(N, K, sizes):
    """rans_encode_chain on K chains (plain) against JAX's
    rans_encode_body_batch over the same chain: identical words, per-slice
    cursors and states per image; each image's row equals its chain
    encoded alone by the 1-D call."""
    rng = np.random.default_rng(200 + N + K)
    st_fr = batch_chain_inputs(rng, K, sizes)
    cap = sum(fr.shape[1] for _, fr in st_fr) + N
    states = torch.full((K, N), tr.RANS_L, dtype=torch.int64)
    cursor = torch.zeros((K,), dtype=torch.int32)
    buf = torch.zeros((K, cap), dtype=torch.int32)
    offsets = torch.from_numpy(np.cumsum([0] + [fr.shape[1]
                                                for _, fr in st_fr]))
    starts = torch.from_numpy(np.concatenate([st for st, _ in st_fr], 1))
    freqs = torch.from_numpy(np.concatenate([fr for _, fr in st_fr], 1))
    cursors = tr.rans_encode_chain(starts, freqs, offsets, states, cursor,
                                   buf)
    assert cursors.shape == (K, len(sizes)) and cursors.dtype == torch.int32

    jbuf, jcurs, jst = _jax_chain_batch(
        tuple((jnp.asarray(st), jnp.asarray(fr)) for st, fr in st_fr),
        jnp.full((K, N), jr.RANS_L, jnp.uint32), jnp.zeros((K, cap),
                                                           jnp.int32))
    np.testing.assert_array_equal(cursors.numpy(), np.asarray(jcurs))
    np.testing.assert_array_equal(cursor.numpy(), np.asarray(jcurs)[:, -1])
    np.testing.assert_array_equal(states.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))

    for k in range(K):  # K = 1's batched call equals today's 1-D call
        s1 = torch.full((N,), tr.RANS_L, dtype=torch.int64)
        c1 = torch.zeros((1,), dtype=torch.int32)
        b1 = torch.zeros((cap,), dtype=torch.int32)
        cur1 = tr.rans_encode_chain(starts[k].contiguous(),
                                    freqs[k].contiguous(), offsets, s1, c1,
                                    b1)
        assert torch.equal(cur1, cursors[k]) and torch.equal(s1, states[k])
        assert torch.equal(b1, buf[k])


@pytest.mark.parametrize("N,K", [(16, 3), (32, 1)])
def test_batched_decode_matches_jax(N, K):
    """rans_decode with [K, ...] carries (plain) against JAX's
    rans_decode_body_batch, slice by slice over K streams of different
    lengths zero-padded to the longest: identical symbols, states and
    offsets; each image also equals its own 1-D decode."""
    rng = np.random.default_rng(300 + N + K)
    shapes = [(513, 257), (222, 513), (64, 33)]
    images, blobs = [], []
    for _ in range(K):
        slices = []
        for n, Lp in shapes:
            cum = make_cum(rng, n, Lp, floor0=True)
            slices.append((cum, sample_syms(rng, cum)))
        images.append(slices)
        blobs.append(port_encode(slices, N)[0])
    unpacked = [tr.unpack_stream(b, N) for b in blobs]
    W = max(w.size for _, w in unpacked)
    assert len({w.size for _, w in unpacked}) == K  # ragged streams
    words = np.zeros((K, W), np.int32)
    for k, (_, w) in enumerate(unpacked):
        words[k, :w.size] = w
    states0 = np.stack([s for s, _ in unpacked])

    states = torch.from_numpy(states0.astype(np.int64))
    offset = torch.zeros((K,), dtype=torch.int32)
    words_t = torch.from_numpy(words)
    jst, joff = jnp.asarray(states0), jnp.zeros((K,), jnp.int32)
    for s, (n, _) in enumerate(shapes):
        cum = np.stack([img[s][0] for img in images])
        got = tr.rans_decode(torch.from_numpy(cum), words_t, states, offset)
        assert got.shape == (K, n)
        jsyms, jst, joff = jr.rans_decode_body_batch(
            jnp.asarray(cum), jnp.asarray(words), jst, joff, N, n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jsyms))
        np.testing.assert_array_equal(
            got.numpy(), np.stack([img[s][1] for img in images]))
    np.testing.assert_array_equal(states.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(offset.numpy(), np.asarray(joff))
    for k in range(K):
        out, st, off, _ = port_decode(blobs[k], images[k], N)
        assert torch.equal(st, states[k]) and off == int(offset[k])


def test_batched_wrappers_reject_mismatched_k():
    cum = torch.zeros((2, 4, 9), dtype=torch.int32)
    words = torch.zeros((2, 5), dtype=torch.int32)
    states = torch.full((2, 4), tr.RANS_L, dtype=torch.int64)
    off = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError):
        tr.rans_decode(cum, words[:1], states, off)
    with pytest.raises(ValueError):
        tr.rans_decode(cum, words, states, off[:1])
    with pytest.raises(ValueError):
        tr.rans_decode(cum, words[:, ::2], states, off)
    st = torch.zeros((2, 10), dtype=torch.int32)
    offsets = torch.tensor([0, 10])
    with pytest.raises(ValueError):
        tr.rans_encode_chain(st, st, offsets, states[:1], off[:1],
                             torch.zeros((2, 16), dtype=torch.int32))
    with pytest.raises(ValueError):
        tr.rans_encode_chain(st, st, offsets, states, off,
                             torch.zeros((16,), dtype=torch.int32))
