"""Every generator repeats for a given seed, and every seed gets the same work."""

import collections
import itertools
import json

import torch

from portbench import traffic
from portbench.reference import stream
from portbench.spec import ROOT


def _mixes():
    for path in sorted((ROOT / "portbench" / "traffic").glob("*.json")):
        t = json.loads(path.read_text())
        if "mix" in t:
            yield path.stem, t


def test_request_generator_repeats_for_a_seed():
    for name, t in _mixes():
        a = list(itertools.islice(traffic.requests(t["mix"], t["pool"], t["check_every"], 2**31 + 7), 500))
        b = list(itertools.islice(traffic.requests(t["mix"], t["pool"], t["check_every"], 2**31 + 7), 500))
        c = list(itertools.islice(traffic.requests(t["mix"], t["pool"], t["check_every"], 5), 500))
        assert a == b, name
        assert a != c or len(t["mix"]) == 1 and t["pool"] == t["mix"][0][0], name


def test_every_block_holds_the_mix_exactly():
    for name, t in _mixes():
        block = sum(n for _, n in t["mix"])
        for seed in (1, 2**31 + 11):
            reqs = list(itertools.islice(traffic.requests(t["mix"], t["pool"], t["check_every"], seed), 3 * block))
            for i in range(3):
                got = collections.Counter(r.crops for r in reqs[i * block : (i + 1) * block])
                assert got == {size: n for size, n in t["mix"]}, name
            assert all(0 <= r.offset <= t["pool"] - r.crops for r in reqs)


def test_check_sample_holds_the_largest_request():
    for name, t in _mixes():
        largest = max(size for size, _ in t["mix"])
        reqs = list(itertools.islice(traffic.requests(t["mix"], t["pool"], t["check_every"], 99), 4000))
        kept = [r for r in reqs if r.keep]
        assert any(r.crops == largest for r in kept), name
        assert len(kept) >= 4000 // t["check_every"], name


def test_stream_draws_repeat_for_a_seed():
    s = stream.Stream(targets="hard", bg_mode="texture", color_jitter=0.08, shading=0.6, occluders=2)

    def draw(seed):
        gen = torch.Generator().manual_seed(stream.step_seed(seed, 3))
        return stream.draws(gen, 2, 24, 10, 19, 24, s, 32)

    a, b, c = draw(2**31 + 5), draw(2**31 + 5), draw(6)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["pose"], c["pose"])
