"""The traffic's source: the same seed gives the same batches, on the
reader's thread as in ``batches``; ids lie in 1..vocab-1, rows differ, and
the ids' frequencies follow the Zipf law the traffic states."""
import threading

import numpy as np
import pytest

from portbench.bench import layout

SEED = 2 ** 31 + 12345  # seeds may pass 32 signed bits


@pytest.mark.parametrize("traffic", layout.names("traffic"))
def test_source_is_deterministic_by_seed(traffic):
    tr = layout.load_json("traffic", traffic)
    src = layout.load_module("sources", tr["source"])
    a = src.batches(tr, 49152, SEED, 3)
    got = []

    def read():
        sess = src.make(tr, 49152, SEED).session(zero_copy=True)
        for i, b in enumerate(sess):
            got.append(b)
            if i == 2:
                sess.close()

    t = threading.Thread(target=read)
    t.start()
    t.join()
    assert len(got) == 3
    for x, y in zip(a, got):
        for k in ("tokens", "labels"):
            assert x[k].shape == (tr["batch"], tr["seq"]) and x[k].dtype == np.int64
            assert np.array_equal(x[k], y[k])
        assert np.array_equal(x["tokens"][:, 1:], x["labels"][:, :-1])
        assert x["tokens"].min() >= 1 and x["labels"].max() <= 49151
    other = src.batches(tr, 49152, SEED + 1, 1)[0]
    assert not np.array_equal(other["tokens"], a[0]["tokens"])
    rows = np.concatenate([b["tokens"] for b in a])
    assert len({r.tobytes() for r in rows}) == len(rows)


@pytest.mark.parametrize("traffic", layout.names("traffic"))
def test_ids_follow_the_zipf_law(traffic):
    tr = layout.load_json("traffic", traffic)
    src = layout.load_module("sources", tr["source"])
    vocab = 50277
    ids = np.concatenate([b["tokens"].ravel() for b in src.batches(tr, vocab, SEED, 40)])
    ranks = np.arange(1, vocab, dtype=np.float64)
    p = ranks ** -tr["zipf_a"] / (ranks ** -tr["zipf_a"]).sum()
    share = np.bincount(ids, minlength=vocab)[1:] / len(ids)
    n = len(ids)
    for r in (1, 2, 10, 100):  # within 5 standard errors of the law
        assert abs(share[r - 1] - p[r - 1]) < 5 * np.sqrt(p[r - 1] / n), (r, share[r - 1])
    assert ids.max() <= vocab - 1
