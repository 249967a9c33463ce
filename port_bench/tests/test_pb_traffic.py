"""The traffic generator: deterministic in its seed, and every seed offers
the same sizes."""
import json

import numpy as np
import pb_smoke  # noqa: F401  (paths)

from port_bench import inputs, traffic


def _mix(name):
    return inputs.load_json("traffic", f"{name}.json")


def test_episode_is_deterministic_in_the_seed():
    mix = _mix("adapt")
    a = traffic.episode(mix, 50280, 2 ** 33 + 1, 3)
    b = traffic.episode(mix, 50280, 2 ** 33 + 1, 3)
    c = traffic.episode(mix, 50280, 2 ** 33 + 2, 3)
    for part in ("support", "query", "pseudo_query"):
        for k in ("tokens", "episode_labels"):
            assert np.array_equal(getattr(a, part)[k], getattr(b, part)[k])
    assert not np.array_equal(a.support["tokens"], c.support["tokens"])
    # same shapes and labels whatever the seed: the same work
    assert a.support["tokens"].shape == (mix["pad"], mix["seq"])
    assert np.array_equal(a.support["episode_labels"],
                          c.support["episode_labels"])
    assert a.n_support == mix["way"] * mix["shots"]
    assert (a.support["tokens"] < 50280).all()


def test_pseudo_query_rerolls_spans_of_the_support():
    mix = _mix("adapt")
    e = traffic.episode(mix, 1000, 7, 0)
    diff = e.pseudo_query["tokens"] != e.support["tokens"]
    n = e.n_support
    assert diff[:n].any(axis=1).mean() > 0.5
    assert not diff[n:].any()  # padded rows untouched
    assert diff[:n].sum(axis=1).max() < mix["seq"] // 16


def test_mix_files_are_plain_data():
    for name in ("adapt",):
        with open(f"{inputs.ROOT}/traffic/{name}.json") as f:
            assert isinstance(json.load(f)["kind"], str)
