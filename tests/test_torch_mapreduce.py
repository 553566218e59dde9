"""The port's MapReduce data plane (local half) against repro.mapreduce,
jitted on the CPU: the five jobs on both corpus kinds (keys, counts and
n_unique equal), the filtering percentage FP bit-equal on
benchmarks/bench_filtering.py's shards, the uint32 wrap of the 3-gram
hash at large token ids, and a custom Grep pattern."""
import collections

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import mapreduce as jmr  # noqa: E402
from repro.mapreduce import engine as jengine  # noqa: E402
from repro.mapreduce import jobs as jjobs  # noqa: E402
from repro_torch import mapreduce as mr  # noqa: E402
from repro_torch.mapreduce import engine, jobs  # noqa: E402

KINDS = ("web", "non-web")


def _both(spec_name, tokens, lengths):
    """(port, JAX) local_mapreduce of one shard, as numpy (keys int64)."""
    k, v, n = mr.local_mapreduce(mr.JOBS[spec_name], tokens, lengths,
                                 device="cpu")
    K, V, N = jmr.local_mapreduce(jmr.JOBS[spec_name], jnp.asarray(tokens),
                                  jnp.asarray(lengths))
    return ((k.numpy(), v.numpy(), int(n)),
            (np.asarray(K).astype(np.int64), np.asarray(V), int(N)))


def test_corpus_and_word_len_are_jax_copies():
    for kind in KINDS:
        for seed in (0, 7):
            t, l = mr.corpus(kind, 3000, seed=seed)
            jt, jl = jmr.corpus(kind, 3000, seed=seed)
            np.testing.assert_array_equal(t, jt)
            np.testing.assert_array_equal(l, jl)
    ids = np.arange(-3, 5000, dtype=np.int32)
    np.testing.assert_array_equal(jobs.word_len(ids), jjobs.word_len(ids))
    assert set(mr.JOBS) == set(jmr.JOBS)
    for name, spec in mr.JOBS.items():
        jspec = jmr.JOBS[name]
        assert (spec.cap_mult, spec.combine_in_map) == (
            jspec.cap_mult, jspec.combine_in_map)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("job", sorted(jmr.JOBS))
def test_local_mapreduce_matches_jax(job, kind):
    """Keys (sorted, EMPTY past n_unique), counts and n_unique equal."""
    tok, lng = mr.corpus(kind, 6000, seed=11)
    (k, v, n), (K, V, N) = _both(job, tok, lng)
    assert n == N > 0
    assert k.dtype == np.int64 and v.dtype == np.int32
    np.testing.assert_array_equal(k, K)
    np.testing.assert_array_equal(v, V)
    assert (k[n:] == jobs.EMPTY).all() and (k[:n] != jobs.EMPTY).all()


@pytest.mark.parametrize("kind", KINDS)
def test_wordcount_matches_python_oracle(kind):
    tok, lng = mr.corpus(kind, 2048, seed=1)
    k, v, n = mr.local_mapreduce(mr.JOBS["WC"], tok, lng, device="cpu")
    got = {int(a): int(b) for a, b in zip(k[:int(n)], v[:int(n)])}
    assert got == dict(collections.Counter(int(t) for t in tok))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("job", sorted(jmr.JOBS))
def test_measure_fp_bit_equal_on_bench_filtering_shards(job, kind):
    """benchmarks/bench_filtering.py's shards (seeds 1000 + s, 4096
    tokens): the port's float32 FP has JAX's bits."""
    shards = [mr.corpus(kind, 4096, seed=1000 + s) for s in range(8)]
    st = np.stack([t for t, _ in shards])
    sl = np.stack([l for _, l in shards])
    got = mr.measure_fp(mr.JOBS[job], st, sl, device="cpu")
    want = jmr.measure_fp(jmr.JOBS[job], st, sl)
    assert got.dtype == np.float32 and got.shape == (8,)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_combiner_bytes_have_no_hash_collision():
    """SC's combiner keeps the bytes of one member per key. JAX's scatter
    does not say which; the port takes the first. They agree because the
    members of a key are one 3-gram (the same words, the same bytes): no
    two different 3-grams of these shards share a hash."""
    for kind in KINDS:
        for s in range(8):
            tok, _ = mr.corpus(kind, 4096, seed=1000 + s)
            h, ok = jobs._gram3(torch.from_numpy(tok))
            grams = np.stack([tok, np.roll(tok, -1), np.roll(tok, -2)], 1)
            by_hash = collections.defaultdict(set)
            for key, g in zip(h[ok].tolist(), grams[ok.numpy()]):
                by_hash[key].add(tuple(g))
            assert all(len(g) == 1 for g in by_hash.values()), (kind, s)


@pytest.mark.parametrize("job", ["SC", "Permu"])
def test_uint32_wrap_at_large_token_ids(job):
    """Token ids near 2^31 make every product of the 3-gram hash wrap mod
    2^32 (JAX's uint32 multiplies); the port's int64 keys hold the same
    values, and a -1 padding token drops the 3-grams it is in."""
    rng = np.random.RandomState(2)
    tok = rng.randint(2**31 - 5000, 2**31 - 1, 3000).astype(np.int32)
    tok[rng.randint(0, 3000, 20)] = -1
    tok[100:130] = tok[200:230]        # repeated 3-grams: counts above 1
    lng = jobs.word_len(np.maximum(tok, 0))
    (k, v, n), (K, V, N) = _both(job, tok, lng)
    assert n == N
    np.testing.assert_array_equal(k, K)
    np.testing.assert_array_equal(v, V)
    assert v.max() > 1 and k[:n].max() > 2**31
    kv = jobs._gram3(torch.from_numpy(tok))[0]
    jh, _ = jjobs._gram3(jnp.asarray(tok))
    np.testing.assert_array_equal(kv.numpy(), np.asarray(jh).astype(np.int64))


def test_mul32_is_the_uint32_product():
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randint(0, 2**32, 1000, dtype=np.uint64),
                        np.array([0, 1, 2**32 - 1], np.uint64)])
    for c in (2654435761, 40503, 69427, 2**32 - 1):
        want = (x * np.uint64(c)) % np.uint64(2**32)
        got = jobs._mul32(torch.from_numpy(x.astype(np.int64)), c)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_custom_grep_pattern():
    """grep_map_factory with a pattern drawn from the shard: the counts
    are its occurrences, keyed by position, as JAX's."""
    tok, lng = mr.corpus("web", 4096, seed=2)
    pattern = int(tok[10])
    spec = jobs.MapReduceSpec("Grep", jobs.grep_map_factory(pattern), 1,
                              False)
    jspec = jjobs.MapReduceSpec("Grep", jjobs.grep_map_factory(pattern), 1,
                                False)
    k, v, n = mr.local_mapreduce(spec, tok, lng, device="cpu")
    K, V, N = jmr.local_mapreduce(jspec, jnp.asarray(tok), jnp.asarray(lng))
    assert int(n) == int(N) == int((tok == pattern).sum())
    np.testing.assert_array_equal(k.numpy(), np.asarray(K).astype(np.int64))
    np.testing.assert_array_equal(k[:int(n)].numpy(),
                                  np.nonzero(tok == pattern)[0])
    got = mr.measure_fp(spec, tok[None], lng[None], device="cpu")
    want = jmr.measure_fp(jspec, tok[None], lng[None])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_sort_reduce_matches_jax_with_duplicates_and_empty():
    """_sort_reduce directly, both byte modes: keys with repeats, EMPTY
    slots, the combiner's one kv per key."""
    rng = np.random.RandomState(5)
    keys = rng.randint(0, 50, 400).astype(np.uint32)
    keys[rng.randint(0, 400, 40)] = jjobs.EMPTY
    vals = rng.randint(0, 9, 400).astype(np.int32)
    nbytes = (keys % 7 + 3).astype(np.int32)       # bytes follow the key
    for combined in (False, True):
        got = engine._sort_reduce(torch.from_numpy(keys.astype(np.int64)),
                                  torch.from_numpy(vals),
                                  torch.from_numpy(nbytes),
                                  combined_bytes=combined)
        want = jengine._sort_reduce(jnp.asarray(keys), jnp.asarray(vals),
                                    jnp.asarray(nbytes),
                                    combined_bytes=combined)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g),
                                          np.asarray(w).astype(
                                              np.asarray(g).dtype))


def test_entry_points_default_to_the_card():
    """numpy inputs go to the card unless the caller names the CPU; a CPU
    tensor stays on the CPU."""
    tok, lng = mr.corpus("non-web", 64, seed=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mr.measure_fp(mr.JOBS["WC"], tok[None], lng[None])
    k, _, _ = mr.local_mapreduce(mr.JOBS["WC"], torch.from_numpy(tok),
                                 torch.from_numpy(lng))
    assert k.device.type == "cpu"
