"""Port parity: the e2 library (L5 ops: the Markov chain, the binary
vectorizer, categorical naive Bayes) vs the JAX reference, on the CPU.

Mirrors tests/test_e2_extras.py (`TestMarkovChain`,
`TestBinaryVectorizer`) and tests/test_naive_bayes.py
(`TestCategoricalNB`); each case feeds the same seeded numpy inputs to
both packages. Tolerances: the Markov tables and the vectorizer's maps
and outputs are held exactly (both are host numpy); Markov `predict`
within 1e-6 absolute of JAX's `_mc_predict` on distributions (float32
sums of at most a few dozen terms in another order); the categorical
priors and likelihoods within 1e-12 (the same float32 counts, exact
below 2^24, through the same float64 logs), and its `predict` and
`log_score` answers equal.
"""

import math

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import markov as JM
from predictionio_tpu.ops import naive_bayes as JNB
from predictionio_tpu.ops import vectorizer as JV
from predictionio_tpu_torch import weights
from predictionio_tpu_torch.ops import markov as TM
from predictionio_tpu_torch.ops import naive_bayes as TNB
from predictionio_tpu_torch.ops import vectorizer as TV

PREDICT_TOL = 1e-6
NB_TOL = 1e-12


def seeded_coo(seed: int, n_states: int, nnz: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_states, nnz), rng.integers(0, n_states, nnz),
            rng.integers(1, 9, nnz).astype(np.float64))


# -- Markov chain --------------------------------------------------------------

class TestMarkovChain:
    def test_row_normalized_topn(self):
        m = TM.markov_chain_train([0, 0, 1], [1, 2, 0], [3, 1, 2], 3,
                                  top_n=2, device="cpu")
        np.testing.assert_allclose(m.probs[0], [0.75, 0.25], rtol=1e-6)
        assert m.indices[0].tolist() == [1, 2]
        assert m.indices[2].tolist() == [-1, -1]
        assert m.device == torch.device("cpu")

    def test_topn_prunes_smallest(self):
        m = TM.markov_chain_train([0, 0, 0], [0, 1, 2], [5, 1, 4], 3,
                                  top_n=2, device="cpu")
        assert set(m.indices[0].tolist()) == {0, 2}
        np.testing.assert_allclose(sorted(m.probs[0]), [0.4, 0.5])

    def test_predict_propagates(self):
        m = TM.markov_chain_train([0, 1], [1, 2], [1, 1], 3, top_n=1,
                                  device="cpu")
        out = m.predict(np.array([1.0, 0.0, 0.0]))
        np.testing.assert_allclose(out, [0, 1.0, 0])
        np.testing.assert_allclose(m.predict(out), [0, 0, 1.0])

    def test_predict_mixes_rows(self):
        m = TM.markov_chain_train([0, 0, 1], [1, 2, 2], [1, 1, 1], 3,
                                  top_n=2, device="cpu")
        np.testing.assert_allclose(m.predict(np.array([0.5, 0.5, 0.0])),
                                   [0, 0.25, 0.75])

    @pytest.mark.parametrize("seed, n_states, nnz, top_n", [
        (0, 50, 400, 5), (1, 200, 3000, 20), (2, 31, 20, 4)])
    def test_tables_and_predict_match_the_reference(self, seed, n_states,
                                                    nnz, top_n):
        r, c, v = seeded_coo(seed, n_states, nnz)
        port = TM.markov_chain_train(r, c, v, n_states, top_n, device="cpu")
        ref = JM.markov_chain_train(r, c, v, n_states, top_n)
        assert port.indices.dtype == ref.indices.dtype
        assert port.probs.dtype == ref.probs.dtype
        assert np.array_equal(port.indices, ref.indices)
        assert np.array_equal(port.probs, ref.probs)
        assert (port.n_states, port.top_n) == (ref.n_states, ref.top_n)
        rng = np.random.default_rng(seed + 10)
        for _ in range(3):
            cur = rng.random(n_states)
            cur /= cur.sum()
            got, want = port.predict(cur), ref.predict(cur)
            assert got.dtype == np.float32 and got.shape == (n_states,)
            assert np.abs(got - want).max() <= PREDICT_TOL

    def test_mc_predict_sends_padding_to_the_extra_bin(self):
        idx = torch.tensor([[1, -1], [-1, -1]], dtype=torch.int32)
        probs = torch.tensor([[0.5, 9.0], [7.0, 7.0]])
        out = TM.mc_predict(idx, probs, torch.tensor([1.0, 1.0]), 2)
        assert out.tolist() == [0.0, 0.5]

    def test_from_jax_markov_model_carries_the_reference_model(self):
        r, c, v = seeded_coo(4, 40, 300)
        ref = JM.markov_chain_train(r, c, v, 40, 6)
        port = weights.from_jax_markov_model(ref.indices, ref.probs,
                                             ref.n_states, ref.top_n,
                                             device="cpu")
        assert np.array_equal(port.indices, ref.indices)
        cur = np.random.default_rng(5).random(40)
        assert np.abs(port.predict(cur) - ref.predict(cur)).max() <= \
            PREDICT_TOL
        with pytest.raises(ValueError, match=r"not \[40, 5\]"):
            weights.from_jax_markov_model(ref.indices, ref.probs, 40, 5,
                                          device="cpu")
        bad = ref.indices.copy()
        bad[0, 0] = 40
        with pytest.raises(ValueError, match="outside"):
            weights.from_jax_markov_model(bad, ref.probs, 40, 6,
                                          device="cpu")


# -- binary vectorizer ----------------------------------------------------------

def seeded_maps(seed: int, n: int):
    rng = np.random.default_rng(seed)
    props = ("color", "size", "brand", "shape")
    return [{p: f"{p[0]}{rng.integers(0, 4)}" for p in props
             if rng.random() < 0.7} for _ in range(n)]


class TestBinaryVectorizer:
    def test_fit_transform(self):
        maps = [{"color": "red", "size": "L"}, {"color": "blue"}]
        v = TV.BinaryVectorizer.fit(maps, ["color", "size"])
        assert v.n_features == 3
        assert v.transform({"color": "red", "size": "L"}).sum() == 2.0
        assert v.transform({"color": "green"}).sum() == 0.0

    def test_only_requested_properties(self):
        v = TV.BinaryVectorizer.fit([{"a": "1", "b": "2"}], ["a"])
        assert v.n_features == 1

    def test_batch(self):
        v = TV.BinaryVectorizer.fit([{"a": "1"}, {"a": "2"}], ["a"])
        X = v.transform_batch([{"a": "1"}, {"a": "2"}, {"a": "3"}])
        assert X.shape == (3, 2) and X.sum() == 2.0
        assert v.transform_batch([]).shape == (0, 2)

    @pytest.mark.parametrize("seed, props", [
        (0, ["color", "size"]), (1, ["brand", "shape", "color"]),
        (2, ["size", "missing"])])
    def test_maps_and_outputs_match_the_reference(self, seed, props):
        maps = seeded_maps(seed, 60)
        port = TV.BinaryVectorizer.fit(maps, props)
        ref = JV.BinaryVectorizer.fit(maps, props)
        assert port.property_map == ref.property_map
        queries = seeded_maps(seed + 100, 20) + [{}]
        got, want = port.transform_batch(queries), \
            ref.transform_batch(queries)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        carried = weights.from_jax_binary_vectorizer(ref.property_map)
        assert np.array_equal(carried.transform_batch(queries), want)

    def test_from_jax_binary_vectorizer_refuses_gapped_columns(self):
        with pytest.raises(ValueError, match="0..n-1"):
            weights.from_jax_binary_vectorizer({("a", "1"): 0,
                                                ("a", "2"): 2})


# -- categorical naive Bayes ------------------------------------------------------

FIXTURE = [
    ("spam", ("cheap", "buy")),
    ("spam", ("cheap", "now")),
    ("spam", ("free", "buy")),
    ("ham", ("meeting", "now")),
    ("ham", ("cheap", "agenda")),
]


def points(pkg, rows):
    return [pkg.LabeledPoint(label, tuple(f)) for label, f in rows]


def seeded_rows(seed: int, n: int, n_pos: int, n_labels: int):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_labels, n)
    vals = (rng.integers(0, 6, (n, n_pos)) + labels[:, None]) % 9
    return [(f"l{labels[j]}", tuple(f"v{x}" for x in vals[j]))
            for j in range(n)]


def assert_nb_close(port, ref):
    assert list(port.priors) == list(ref.priors)
    for label in ref.priors:
        assert abs(port.priors[label] - ref.priors[label]) <= NB_TOL
        assert len(port.likelihoods[label]) == len(ref.likelihoods[label])
        for m_p, m_r in zip(port.likelihoods[label],
                            ref.likelihoods[label]):
            assert list(m_p) == list(m_r)
            for v in m_r:
                assert abs(m_p[v] - m_r[v]) <= NB_TOL


class TestCategoricalNB:
    def test_priors_and_likelihoods(self):
        model = TNB.categorical_nb_train(points(TNB, FIXTURE), device="cpu")
        assert model.priors["spam"] == pytest.approx(math.log(3 / 5))
        assert model.priors["ham"] == pytest.approx(math.log(2 / 5))
        assert model.likelihoods["spam"][0]["cheap"] == \
            pytest.approx(math.log(2 / 3))
        assert model.likelihoods["ham"][1]["agenda"] == \
            pytest.approx(math.log(1 / 2))
        assert "meeting" not in model.likelihoods["spam"][0]

    def test_log_score_and_none_for_unseen(self):
        model = TNB.categorical_nb_train(points(TNB, FIXTURE), device="cpu")
        s = model.log_score(TNB.LabeledPoint("spam", ("cheap", "buy")))
        assert s == pytest.approx(
            math.log(3 / 5) + math.log(2 / 3) + math.log(2 / 3))
        assert model.log_score(
            TNB.LabeledPoint("spam", ("meeting", "buy"))) is None
        assert model.log_score(
            TNB.LabeledPoint("nolabel", ("cheap", "buy"))) is None

    def test_default_likelihood_fallback(self):
        model = TNB.categorical_nb_train(points(TNB, FIXTURE), device="cpu")
        assert model.log_score(
            TNB.LabeledPoint("spam", ("meeting", "buy")),
            default=lambda m: min(m.values()) - 1.0) is not None

    def test_predict(self):
        model = TNB.categorical_nb_train(points(TNB, FIXTURE), device="cpu")
        assert model.predict(("cheap", "buy")) == "spam"
        assert model.predict(("meeting", "now")) == "ham"

    def test_empty_training_set(self):
        model = TNB.categorical_nb_train([], device="cpu")
        assert model.priors == {} and model.predict(("a",)) is None

    @pytest.mark.parametrize("seed, n, n_pos, n_labels", [
        (0, 5, 2, 2), (1, 300, 4, 3), (2, 1000, 8, 5)])
    def test_model_and_answers_match_the_reference(self, mesh8, seed, n,
                                                   n_pos, n_labels):
        rows = FIXTURE if n == 5 else seeded_rows(seed, n, n_pos, n_labels)
        port = TNB.categorical_nb_train(points(TNB, rows), device="cpu")
        ref = JNB.categorical_nb_train(points(JNB, rows), mesh8)
        assert_nb_close(port, ref)
        queries = [f for _, f in seeded_rows(seed + 7, 40, len(rows[0][1]),
                                             n_labels)] + [f for _, f in rows]
        default = lambda m: min(m.values()) - 1.0   # noqa: E731
        for f in queries:
            assert port.predict(f) == ref.predict(f)
            assert port.predict(f, default) == ref.predict(f, default)
            for label in list(ref.priors) + ["nolabel"]:
                a = port.log_score(TNB.LabeledPoint(label, f))
                b = ref.log_score(JNB.LabeledPoint(label, f))
                assert (a is None) == (b is None)
                if a is not None:
                    assert abs(a - b) <= NB_TOL * len(f)

    def test_counts_are_the_bincount_of_the_triples(self):
        rng = np.random.default_rng(9)
        n, n_pos, n_classes, n_values = 2000, 5, 4, 11
        lab = rng.integers(0, n_classes, n)
        feat = rng.integers(0, n_values, (n, n_pos))
        counts, label_counts = TNB.categorical_counts(
            torch.from_numpy(lab), torch.from_numpy(feat), n_classes,
            n_values)
        flat = ((lab[:, None] * n_pos + np.arange(n_pos)) * n_values
                + feat).ravel()
        assert counts.dtype == torch.float32
        assert np.array_equal(counts.numpy().ravel(), np.bincount(
            flat, minlength=n_classes * n_pos * n_values))
        assert np.array_equal(label_counts.numpy(),
                              np.bincount(lab, minlength=n_classes))

    def test_from_jax_categorical_nb_model_carries_the_reference_model(
            self, mesh8):
        rows = seeded_rows(3, 200, 3, 3)
        ref = JNB.categorical_nb_train(points(JNB, rows), mesh8)
        port = weights.from_jax_categorical_nb_model(ref.priors,
                                                     ref.likelihoods)
        assert port.priors == ref.priors
        assert port.likelihoods == ref.likelihoods
        for _, f in rows[:20]:
            assert port.predict(f) == ref.predict(f)
        with pytest.raises(ValueError, match="likelihoods"):
            weights.from_jax_categorical_nb_model({"a": 0.0}, {})
