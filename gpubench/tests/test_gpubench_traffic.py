"""The traffic generator and its clients."""

import json
import threading
import time
from concurrent.futures import Future

import pytest

from gpubench import traffic

from conftest import REPO


def _mix(name):
    return traffic.Mix.from_file(name, json.loads((REPO / f"gpubench/traffic/{name}.json").read_text()))


@pytest.mark.parametrize("name", ["batch8", "interactive"])
def test_traffic_repeats_for_a_seed_and_differs_between_seeds(name):
    mix = _mix(name)
    a = [traffic.request_params(2**31 + 17, i, mix) for i in range(50)]
    b = [traffic.request_params(2**31 + 17, i, mix) for i in range(50)]
    c = [traffic.request_params(2**31 + 18, i, mix) for i in range(50)]
    assert a == b
    assert all(x != y for x, y in zip(a, c))
    for prompt, seed, sig in a:
        assert mix.words[0] <= len(prompt.split()) <= mix.words[1]
        assert 0 <= seed < 2**62 and sig == {}


def test_closed_loop_keeps_its_requests_in_flight_until_the_window_closes():
    lock = threading.Lock()
    live, most = [0], [0]

    def submit(rec):
        fut = Future()
        with lock:
            live[0] += 1
            most[0] = max(most[0], live[0])

        def finish():
            time.sleep(0.01)
            with lock:
                live[0] -= 1
            fut.set_result(rec.index)

        threading.Thread(target=finish).start()
        return fut

    recs, t0, t_end = traffic.closed_loop(submit, lambda i: (f"p{i}", i, {}), 4, 0.2)
    assert most[0] == 4
    assert all(r.t_done is not None and r.image == r.index for r in recs)
    assert all(r.t_submit < t_end for r in recs)
    assert len(recs) > 8
    recs, _, _ = traffic.closed_loop(submit, lambda i: (f"p{i}", i, {}), 2, 0.0, total=5)
    assert len(recs) == 5


def test_a_mix_of_another_loop_is_refused():
    with pytest.raises(ValueError):
        traffic.Mix.from_file("x", {"loop": "spiral", "outstanding": 1, "words": [1, 2],
                                    "stretch": 1})
    with pytest.raises(ValueError):  # an open mix names the group sizes it warms
        traffic.Mix.from_file("x", {"loop": "open", "rate_per_s": 2.0, "words": [1, 2],
                                    "stretch": 1})
    with pytest.raises(ValueError):  # a signature sets only what the reference follows
        traffic.Mix.from_file("x", {"loop": "closed", "outstanding": 1, "words": [1, 2],
                                    "stretch": 1, "signatures": [{"deep_cache": 2}]})


OPEN = {"loop": "open", "rate_per_s": 40.0, "burst": [1, 3], "warm": [1, 2, 4],
        "words": [3, 10], "stretch": 4,
        "signatures": [{}, {"height": 48, "width": 32}, {"steps": 2}]}


def test_open_arrivals_and_signatures_repeat_for_a_seed_with_the_same_work():
    mix = traffic.Mix.from_file("open", OPEN)

    def first(seed, n=traffic.BLOCK):
        it = mix.arrivals(seed)
        return [next(it) for _ in range(n)]

    a, b, c = first(2**31 + 1), first(2**31 + 1), first(2**31 + 2)
    assert a == b and a != c
    assert all(x <= y for x, y in zip(a, a[1:]))
    # the same gaps in another order: every seed offers the same load
    def block_gaps(seed):  # the first block of gaps between bursts
        t = sorted(set(first(seed, 3 * traffic.BLOCK)))
        return sorted(round(x - y, 9) for x, y in list(zip(t, [0.0] + t))[:traffic.BLOCK])

    assert block_gaps(2**31 + 1) == block_gaps(2**31 + 2)
    # 256 requests at 40 a second
    assert 4.0 < a[-1] < 9.0

    def sigs(seed):
        return [mix.request_params(seed, i)[2] for i in range(traffic.BLOCK)]

    s1, s2 = sigs(7), sigs(8)
    assert s1 == sigs(7) and s1 != s2
    assert sorted(map(str, s1)) == sorted(map(str, s2))
    assert {str(s) for s in s1} == {str(s) for s in OPEN["signatures"]}


def test_open_loop_sends_on_its_schedule_whatever_is_in_flight():
    def submit(rec):
        fut = Future()
        threading.Timer(0.05, fut.set_result, args=(rec.index,)).start()
        return fut

    times = [0.0, 0.0, 0.01, 0.02, 0.2, 5.0]
    recs, t0, t_end = traffic.open_loop(submit, lambda i: (f"p{i}", i, {}), iter(times), 0.1)
    assert len(recs) == 4  # the arrivals before the window's end
    assert all(r.t_done is not None and r.image == r.index for r in recs)
    assert all(abs(r.t_submit - t0 - times[r.index]) < 0.03 for r in recs)
    recs, _, _ = traffic.open_loop(submit, lambda i: (f"p{i}", i, {}), iter(times), 0.0, total=5)
    assert len(recs) == 5
