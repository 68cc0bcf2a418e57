"""The traffic generator: seeded, exact token counts, the same sizes for
every seed; the training corpus inside the feeder's filter."""

import numpy as np
import pytest

from perfbench import core
from perfbench.reference.frontend import token_count
from perfbench.traffic import generate

SEEDS = [0, 7, 2 ** 31 + 5, 2 ** 33 + 1]


def mix(name):
    return core.load_json(core.HERE / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", ["offline_long", "offline_short"])
def test_texts_seeded_and_exact(name):
    m = mix(name)
    lo, hi = m["tokens"]
    want = sorted(generate.token_counts(lo, hi, m["texts_per_call"]))
    for seed in SEEDS:
        for index in (0, 1, 17):
            texts = generate.texts(m, seed, index)
            assert texts == generate.texts(m, seed, index)
            counts = [token_count(t) for t in texts]
            assert sorted(counts) == want
            assert all(lo <= c <= hi for c in counts)
    assert generate.texts(m, 1, 1) != generate.texts(m, 2, 1)
    assert generate.texts(m, 1, 1) != generate.texts(m, 1, 2)


def test_long_texts_fill_one_bucket_and_budget():
    """Every call's longest text is 120 tokens: bucket 128, 200 steps."""
    m = mix("offline_long")
    assert max(generate.token_counts(*m["tokens"], m["texts_per_call"])) \
        == m["tokens"][1]


def test_sentence_every_length():
    rng = np.random.default_rng(0)
    for n in range(4, 200):
        assert token_count(generate.sentence(rng, n)) == n


def test_corpus_lengths_in_filter():
    m = mix("train_live_b16")
    lengths = generate.corpus_lengths(m)
    assert len(lengths) == m["utterances_per_speaker"]
    # the port's feeder keeps 30 * r <= frames <= 200 * r - r, tokens >= 50
    assert all(120 <= f <= 796 and 50 <= t <= 150 for f, t in lengths)
    assert lengths == generate.corpus_lengths(m)


def test_corpus_seeded(tmp_path):
    m = dict(mix("train_live_b16"), utterances_per_speaker=3,
             frames=[120, 130])
    model = {"num_freq": 9, "num_mels": 4}
    a = generate.corpus(m, model, 5, str(tmp_path / "a"))
    b = generate.corpus(m, model, 5, str(tmp_path / "b"))
    for da, db in zip(a, b):
        for name in ("utt000.npz", "utt002.npz"):
            with np.load(f"{da}/{name}") as x, np.load(f"{db}/{name}") as y:
                for k in x.files:
                    assert np.array_equal(x[k], y[k])
